// Causal (optionally sliding-window) flash attention for Hopper: the
// forward, the dq backward and the dk/dv backward, each one kernel.  For
// bf16 and f16 inputs all three are those of flash_sm90.cu (wgmma, TMA,
// register-resident scores); this file keeps the f32 kernels, the entry
// points and the dispatch.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/pallas_kernels.py:
//   flash_fwd      <- _flash_kernel (:282), called by _flash_fwd_call (:453)
//   flash_bwd_dq   <- _flash_bwd_dq_kernel (:339), pallas_call at :498
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel (:383), pallas_call at :514
// and computes the same functions, with the same casts, per (bh) row of
// (BH, S, D) tensors q, k, v (f32, f16 or bf16; D = 64 or 128):
//
//   s     = f32(q . k^T) * (1/sqrt(D)), visible iff q_pos >= k_pos and,
//           with a window W, q_pos - k_pos < W (masked scores -1e30,
//           masked p 0)
//   fwd   online softmax (m, l) in f32; p is cast to v's dtype before
//         p . v; out = o / max(l, 1e-30); lse = m + log(max(l, 1e-30))
//   dq    p = exp(s - lse); dp = f32(dO . v^T); ds = p * (dp - delta);
//         dq = scale * sum T(ds) . k
//   dkv   per key tile, over the query tiles that can see it:
//         dv += T(p)^T . dO; dk += T(ds)^T . q; dk *= scale
// where delta = rowsum(f32(dO) * f32(out)) comes from the caller, as in
// the JAX package (pallas_kernels.py:496).
//
// Bound on this card (NVIDIA H100 SXM): operations.  Per visible (q, k)
// pair the forward does 4*D flops, dq 6*D and dk/dv 8*D, against 2*D
// bytes read per row of q, k, v and dO; at S = 2048 that is hundreds of
// flops per byte, above the card's ~295 flop/byte balance point.  The
// bound is those flops at 989 TFLOP/s (bf16/f16 tensor cores); for f32
// inputs it is the 67 TFLOP/s of the f32 FMA units, since f32 takes no
// TF32 here.
//
// What the f32 design does about it (a simple design; wgmma, TMA and warp
// specialisation are flash_sm90.cu's, for 16-bit inputs):
//   * products on plain FMAs, one thread per output element;
//   * the TPU's sequential grid loop becomes a loop inside one CTA: one
//     CTA per (bh, query tile) for fwd and dq, one per (bh, key tile)
//     for dk/dv, so no CTA writes what another writes and no atomics are
//     needed;
//   * tiles of q/k/v/dO live in shared memory; scores and the running
//     o, m, l stay in f32 (shared memory and registers), so the S x S
//     matrix never reaches device memory;
//   * tiles wholly outside the causal band or the window are skipped
//     (the same bounds as pallas_kernels.py:323-327 and :426-430), and
//     within each (bh) the CTAs with the longest loops come first;
//   * a sequence the tile does not divide is masked in the kernel (rows
//     past S load as zeros and are never stored), not padded.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

// flash_sm90.cu: the three kernels for 16-bit inputs
cudaError_t hvd_flash_fwd_sm90(bool bf16, int D, const void* q, const void* k, const void* v,
                               void* out, float* lse, int BH, int S, int window, cudaStream_t s);
cudaError_t hvd_flash_dq_sm90(bool bf16, int D, const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta, void* dq,
                              int BH, int S, int window, cudaStream_t s);
cudaError_t hvd_flash_dkv_sm90(bool bf16, int D, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta, void* dk,
                               void* dv, int BH, int S, int window, cudaStream_t s);

namespace {

constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  __device__ static float f32(float x) { return x; }
  __device__ static float from(float x) { return x; }
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Tile shapes and shared-memory strides of the f32 kernels: 32 x 32
// tiles with a pad of 1, so that the scalar loops read shared memory
// without bank conflicts.
template <typename T, int D>
struct Cfg {
  static constexpr int B = 32;       // rows of a q tile = of a k tile
  static constexpr int LDT = D + 1;  // input tiles, B x D
  static constexpr int LDS = B + 4;  // score tiles, B x B
  static constexpr int LDP = B + 1;  // p / ds tiles, B x B
  static constexpr int LDO = D + 4;  // accumulators, B x D
  static constexpr size_t kTile = align128(sizeof(T) * B * LDT);
  static constexpr size_t kScore = align128(sizeof(float) * B * LDS);
  static constexpr size_t kScoreT = align128(sizeof(T) * B * LDP);
  static constexpr size_t kAcc = align128(sizeof(float) * B * LDO);
  static constexpr size_t kRow = align128(sizeof(float) * B);
  static constexpr size_t kFwdBytes = 3 * kTile + kScore + kScoreT + kAcc + kRow;
  static constexpr size_t kDqBytes = 4 * kTile + 2 * kScore + kScoreT + kAcc + 2 * kRow;
  static constexpr size_t kDkvBytes = 4 * kTile + 2 * kScore + 2 * kScoreT + 2 * kAcc + 2 * kRow;
};

__device__ inline char* carve(char*& p, size_t bytes) {
  char* r = p;
  p += align128(bytes);
  return r;
}

__device__ inline bool visible(int qp, int kp, int S, int window) {
  return qp < S && kp < S && qp >= kp && (window <= 0 || qp - kp < window);
}

// rows [row0, row0 + R) of a (S, D) slab into a shared tile of stride
// LD; rows at or past S read as zeros.  16-byte global loads.
template <typename T, int D, int LD, int R>
__device__ void load_rows(T* dst, const T* __restrict__ src, int row0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = D / V;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx % VPR) * V;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * LD + c + j] = f[j];
  }
}

template <int R>
__device__ void load_row_vals(float* dst, const float* __restrict__ src, int row0, int S) {
  for (int r = threadIdx.x; r < R; r += kThreads) dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// Products of shared tiles into an f32 shared tile C (M x N, stride ldc):
// C = [C +] sum_k A(i,k) B(k,j), with three layouts:
//   NT: A(i,k) = A[i*lda + k], B(k,j) = B[j*ldb + k]
//   NN: A(i,k) = A[i*lda + k], B(k,j) = B[k*ldb + j]
//   TN: A(i,k) = A[k*lda + i], B(k,j) = B[k*ldb + j]
// scalar FMAs, one thread per output element, adding the finished sum to
// C as the JAX kernels add a finished dot.
enum class Layout { NT, NN, TN };

template <Layout L, typename T>
__device__ inline float elem_a(const T* A, int lda, int i, int k) {
  return L == Layout::TN ? Cvt<T>::f32(A[k * lda + i]) : Cvt<T>::f32(A[i * lda + k]);
}
template <Layout L, typename T>
__device__ inline float elem_b(const T* B, int ldb, int k, int j) {
  return L == Layout::NT ? Cvt<T>::f32(B[j * ldb + k]) : Cvt<T>::f32(B[k * ldb + j]);
}

template <Layout L, bool ACC, int M, int N, int K, typename T>
__device__ void mm(const T* A, int lda, const T* B, int ldb, float* C, int ldc) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int i = e / N, j = e % N;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(elem_a<L>(A, lda, i, k), elem_b<L>(B, ldb, k, j), s);
    C[i * ldc + j] = ACC ? C[i * ldc + j] + s : s;
  }
}

// (bh, tile) of this CTA; consecutive CTAs share a (bh).  The caller
// numbers tiles heaviest first: the last query tile (fwd, dq) or the
// first key tile (dkv) of a causal row has the longest loop.
__device__ inline void cta_coords(int n_tiles, int& bh, int& tile) {
  bh = blockIdx.x / n_tiles;
  tile = blockIdx.x % n_tiles;
}

// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "16-bit inputs take flash_fwd_sm90_kernel");
  using C = Cfg<T, D>;
  constexpr int B = C::B;
  constexpr int TPR = kThreads / B;  // threads per score row
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  T* sQ = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sK = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sV = reinterpret_cast<T*>(carve(p, C::kTile));
  float* sS = reinterpret_cast<float*>(carve(p, C::kScore));
  T* sP = reinterpret_cast<T*>(carve(p, C::kScoreT));
  float* sO = reinterpret_cast<float*>(carve(p, C::kAcc));
  float* sL = reinterpret_cast<float*>(carve(p, C::kRow));

  const int n_tiles = (S + B - 1) / B;
  int bh, rev;
  cta_coords(n_tiles, bh, rev);
  const int qt = n_tiles - 1 - rev;
  const int q0 = qt * B;
  const size_t base = (size_t)bh * S * D;

  load_rows<T, D, C::LDT, B>(sQ, q + base, q0, S);
  for (int e = threadIdx.x; e < B * D; e += kThreads) sO[(e / D) * C::LDO + e % D] = 0.f;

  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qp = q0 + r;
  float m = kNegInf, l = 0.f;

  const int kt_end = min(n_tiles, (q0 + B - 1) / B + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / B : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_rows<T, D, C::LDT, B>(sK, k + base, k0, S);
    load_rows<T, D, C::LDT, B>(sV, v + base, k0, S);
    __syncthreads();
    mm<Layout::NT, false, B, B, D>(sQ, C::LDT, sK, C::LDT, sS, C::LDS);
    __syncthreads();

    float sv[B / TPR];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < B / TPR; ++j) {
      const int c = part + TPR * j;
      const float s = sS[r * C::LDS + c] * scale;
      sv[j] = visible(qp, k0 + c, S, window) ? s : kNegInf;
      tmax = fmaxf(tmax, sv[j]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < B / TPR; ++j) {
      const int c = part + TPR * j;
      const float pv = visible(qp, k0 + c, S, window) ? expf(sv[j] - m_new) : 0.f;
      sum += pv;
      sP[r * C::LDP + c] = Cvt<T>::from(pv);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = l * alpha + sum;
    m = m_new;
    for (int d = part; d < D; d += TPR) sO[r * C::LDO + d] *= alpha;
    __syncthreads();
    mm<Layout::NN, true, B, D, B>(sP, C::LDP, sV, C::LDT, sO, C::LDO);
  }

  __syncthreads();
  if (part == 0) {
    const float lc = fmaxf(l, 1e-30f);
    sL[r] = lc;
    if (qp < S) lse[(size_t)bh * S + qp] = m + logf(lc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int rr = e / D, d = e % D;
    if (q0 + rr < S) out[base + (size_t)(q0 + rr) * D + d] = Cvt<T>::from(sO[rr * C::LDO + d] / sL[rr]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int window,
                    float scale) {
  static_assert(std::is_same<T, float>::value, "16-bit inputs take flash_dq_sm90_kernel");
  using C = Cfg<T, D>;
  constexpr int B = C::B;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  T* sQ = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sDO = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sK = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sV = reinterpret_cast<T*>(carve(p, C::kTile));
  float* sS = reinterpret_cast<float*>(carve(p, C::kScore));
  float* sDP = reinterpret_cast<float*>(carve(p, C::kScore));
  T* sDS = reinterpret_cast<T*>(carve(p, C::kScoreT));
  float* sDQ = reinterpret_cast<float*>(carve(p, C::kAcc));
  float* sLse = reinterpret_cast<float*>(carve(p, C::kRow));
  float* sDelta = reinterpret_cast<float*>(carve(p, C::kRow));

  const int n_tiles = (S + B - 1) / B;
  int bh, rev;
  cta_coords(n_tiles, bh, rev);
  const int q0 = (n_tiles - 1 - rev) * B;
  const size_t base = (size_t)bh * S * D;

  load_rows<T, D, C::LDT, B>(sQ, q + base, q0, S);
  load_rows<T, D, C::LDT, B>(sDO, dout + base, q0, S);
  load_row_vals<B>(sLse, lse + (size_t)bh * S, q0, S);
  load_row_vals<B>(sDelta, delta + (size_t)bh * S, q0, S);
  for (int e = threadIdx.x; e < B * D; e += kThreads) sDQ[(e / D) * C::LDO + e % D] = 0.f;

  const int kt_end = min(n_tiles, (q0 + B - 1) / B + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / B : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_rows<T, D, C::LDT, B>(sK, k + base, k0, S);
    load_rows<T, D, C::LDT, B>(sV, v + base, k0, S);
    __syncthreads();
    mm<Layout::NT, false, B, B, D>(sQ, C::LDT, sK, C::LDT, sS, C::LDS);
    mm<Layout::NT, false, B, B, D>(sDO, C::LDT, sV, C::LDT, sDP, C::LDS);
    __syncthreads();
    for (int e = threadIdx.x; e < B * B; e += kThreads) {
      const int r = e / B, c = e % B;
      const float pv = visible(q0 + r, k0 + c, S, window)
                           ? expf(sS[r * C::LDS + c] * scale - sLse[r]) : 0.f;
      sDS[r * C::LDP + c] = Cvt<T>::from(pv * (sDP[r * C::LDS + c] - sDelta[r]));
    }
    __syncthreads();
    mm<Layout::NN, true, B, D, B>(sDS, C::LDP, sK, C::LDT, sDQ, C::LDO);
  }

  __syncthreads();
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int r = e / D, d = e % D;
    if (q0 + r < S) dq[base + (size_t)(q0 + r) * D + d] = Cvt<T>::from(sDQ[r * C::LDO + d] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "16-bit inputs take flash_dkv_sm90_kernel");
  using C = Cfg<T, D>;
  constexpr int B = C::B;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  T* sK = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sV = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sQ = reinterpret_cast<T*>(carve(p, C::kTile));
  T* sDO = reinterpret_cast<T*>(carve(p, C::kTile));
  float* sS = reinterpret_cast<float*>(carve(p, C::kScore));
  float* sDP = reinterpret_cast<float*>(carve(p, C::kScore));
  T* sP = reinterpret_cast<T*>(carve(p, C::kScoreT));
  T* sDS = reinterpret_cast<T*>(carve(p, C::kScoreT));
  float* sDK = reinterpret_cast<float*>(carve(p, C::kAcc));
  float* sDV = reinterpret_cast<float*>(carve(p, C::kAcc));
  float* sLse = reinterpret_cast<float*>(carve(p, C::kRow));
  float* sDelta = reinterpret_cast<float*>(carve(p, C::kRow));

  const int n_tiles = (S + B - 1) / B;
  int bh, kt;
  cta_coords(n_tiles, bh, kt);
  const int k0 = kt * B;
  const size_t base = (size_t)bh * S * D;

  load_rows<T, D, C::LDT, B>(sK, k + base, k0, S);
  load_rows<T, D, C::LDT, B>(sV, v + base, k0, S);
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    sDK[(e / D) * C::LDO + e % D] = 0.f;
    sDV[(e / D) * C::LDO + e % D] = 0.f;
  }

  int qt_end = n_tiles;
  if (window > 0) qt_end = min(qt_end, (k0 + B - 1 + window - 1) / B + 1);
  for (int qt = k0 / B; qt < qt_end; ++qt) {
    const int q0 = qt * B;
    __syncthreads();
    load_rows<T, D, C::LDT, B>(sQ, q + base, q0, S);
    load_rows<T, D, C::LDT, B>(sDO, dout + base, q0, S);
    load_row_vals<B>(sLse, lse + (size_t)bh * S, q0, S);
    load_row_vals<B>(sDelta, delta + (size_t)bh * S, q0, S);
    __syncthreads();
    mm<Layout::NT, false, B, B, D>(sQ, C::LDT, sK, C::LDT, sS, C::LDS);
    mm<Layout::NT, false, B, B, D>(sDO, C::LDT, sV, C::LDT, sDP, C::LDS);
    __syncthreads();
    for (int e = threadIdx.x; e < B * B; e += kThreads) {
      const int r = e / B, c = e % B;
      const float pv = visible(q0 + r, k0 + c, S, window)
                           ? expf(sS[r * C::LDS + c] * scale - sLse[r]) : 0.f;
      sP[r * C::LDP + c] = Cvt<T>::from(pv);
      sDS[r * C::LDP + c] = Cvt<T>::from(pv * (sDP[r * C::LDS + c] - sDelta[r]));
    }
    __syncthreads();
    mm<Layout::TN, true, B, D, B>(sP, C::LDP, sDO, C::LDT, sDV, C::LDO);
    mm<Layout::TN, true, B, D, B>(sDS, C::LDP, sQ, C::LDT, sDK, C::LDO);
  }

  __syncthreads();
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int r = e / D, d = e % D;
    if (k0 + r < S) {
      const size_t o = base + (size_t)(k0 + r) * D + d;
      dk[o] = Cvt<T>::from(sDK[r * C::LDO + d] * scale);
      dv[o] = Cvt<T>::from(sDV[r * C::LDO + d]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o1, *o2;  // fwd: out; dq: dq; dkv: dk, dv
  float* lse_out;
  int BH, S, window;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename K>
cudaError_t prepare(K kernel, size_t smem, const Args& a, int B, unsigned& blocks) {
  const long long n = (long long)a.BH * ((a.S + B - 1) / B);
  if (n <= 0) return cudaSuccess;
  if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blocks = (unsigned)n;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// 16-bit inputs: the kernels of flash_sm90.cu
cudaError_t launch_sm90(bool bf16, int which, int D, const Args& a, cudaStream_t s) {
  switch (which) {
    case kFwd:
      return hvd_flash_fwd_sm90(bf16, D, a.q, a.k, a.v, a.o1, a.lse_out, a.BH, a.S, a.window, s);
    case kDq:
      return hvd_flash_dq_sm90(bf16, D, a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.o1, a.BH,
                               a.S, a.window, s);
    case kDkv:
      return hvd_flash_dkv_sm90(bf16, D, a.q, a.k, a.v, a.dout, a.lse_in, a.delta, a.o1, a.o2,
                                a.BH, a.S, a.window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_f32(int which, const Args& a, cudaStream_t s) {
  using T = float;
  using C = Cfg<T, D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  unsigned blocks = 0;
  cudaError_t err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  switch (which) {
    case kFwd:
      err = prepare(flash_fwd_kernel<T, D>, C::kFwdBytes, a, C::B, blocks);
      if (err != cudaSuccess || !blocks) return err;
      flash_fwd_kernel<T, D><<<blocks, kThreads, C::kFwdBytes, s>>>(
          q, k, v, static_cast<float*>(a.o1), a.lse_out, a.S, a.window, scale);
      break;
    case kDq:
      err = prepare(flash_bwd_dq_kernel<T, D>, C::kDqBytes, a, C::B, blocks);
      if (err != cudaSuccess || !blocks) return err;
      flash_bwd_dq_kernel<T, D><<<blocks, kThreads, C::kDqBytes, s>>>(
          q, k, v, dout, a.lse_in, a.delta, static_cast<float*>(a.o1), a.S, a.window, scale);
      break;
    case kDkv:
      err = prepare(flash_bwd_dkv_kernel<T, D>, C::kDkvBytes, a, C::B, blocks);
      if (err != cudaSuccess || !blocks) return err;
      flash_bwd_dkv_kernel<T, D><<<blocks, kThreads, C::kDkvBytes, s>>>(
          q, k, v, dout, a.lse_in, a.delta, static_cast<float*>(a.o1),
          static_cast<float*>(a.o2), a.S, a.window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dtype codes shared with ops/flash_attention.py (and ops/cuda_kernels.py)
enum { kF32 = 0, kF16 = 1, kBF16 = 2 };

int run(int device, int which, int dtype, int D, const Args& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      err = D == 64 ? launch_f32<64>(which, a, s) : D == 128 ? launch_f32<128>(which, a, s)
                                                             : cudaErrorInvalidValue;
      break;
    case kF16: err = launch_sm90(false, which, D, a, s); break;
    case kBF16: err = launch_sm90(true, which, D, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// All tensors contiguous on `device`: q, k, v, dout, out, dq, dk, dv of
// shape (BH, S, D) in `dtype`; lse and delta (BH, S) f32.  window <= 0
// means full causal.  Each returns the cudaError_t of its launch.

int hvd_flash_fwd(int device, const void* q, const void* k, const void* v, void* out, float* lse,
                  int BH, int S, int D, int window, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, BH, S, window};
  return run(device, kFwd, dtype, D, a, stream);
}

int hvd_flash_bwd_dq(int device, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int BH, int S, int D,
                     int window, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, BH, S, window};
  return run(device, kDq, dtype, D, a, stream);
}

int hvd_flash_bwd_dkv(int device, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                      int D, int window, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, BH, S, window};
  return run(device, kDkv, dtype, D, a, stream);
}

}  // extern "C"
