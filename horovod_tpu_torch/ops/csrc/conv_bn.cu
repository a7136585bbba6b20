// Fused 1x1 convolution + BatchNorm statistics: the forward (B9) and the
// backward (B10) of horovod_tpu_torch.ops.conv_bn.conv1x1_bn.
//
// Route, by a fixed rule on dtype and shape (ops/conv_bn.py `route`
// copies it): bf16 problems whose K and N are multiples of 64 go to the
// wgmma/TMA kernels of conv_bn_sm90.cu, everything else (f32, bf16 of
// other widths) to the WMMA kernels below.  Both routes end in a
// fixed-order column sum in colsum_kernel's order (conv_bn_sm90.cu's takes
// four columns to a thread).
//
// Replaces the two Pallas TPU kernels of horovod_tpu/ops/pallas_conv_bn.py:
//   conv_bn_fwd  <- _fwd_kernel (:85), pallas_call in _fwd_call (:125)
//   conv_bn_bwd  <- _bwd_kernel (:149), pallas_call in _bwd_call (:204)
// and computes the same functions, with the same casts, on a row-major
// (M, K) activation x (f32 or bf16), a (K, N) weight w in x's dtype and
// per-channel f32 a, b of length K:
//
//   forward   xh = fold ? bf16(relu(x*a + b)) : x
//             y  = f32(xh @ w)          (f32 accumulation)
//             out y in x's dtype; s1 = sum_rows y, s2 = sum_rows y*y,
//             both taken from the f32 y before its cast
//   backward  ytot = bf16(dy + ds1 + (2*y)*ds2)   (in f32, then rounded)
//             dxh  = f32(ytot @ w^T);  dw = f32(xh^T @ ytot), over all M
//             fold: pre = x*a + b, m = (pre > 0), dxm = dxh*m,
//                   dx = dxm*a, da = sum_rows dxm*x, db = sum_rows dxm
//             else: dx = dxh;  dx in x's dtype, dw/da/db f32
//
// Every elementwise step is the correctly rounded operation the plain
// PyTorch version makes, one at a time: __fmul_rn then __fadd_rn, never
// a contracted fma (nvcc's default -fmad=true would fuse x*a + b and
// could flip the bf16 rounding of xh or the sign of pre against the
// plain version); __float2bfloat16_rn for every cast.
//
// Bound on this card (NVIDIA H100 SXM): operations for the wide layers,
// bytes for the narrow ones.  A (M, K) @ (K, N) product does 2*M*K*N
// flops against 2*(M*K + K*N + M*N) bytes (bf16), so K = N = 64 sits
// below the card's ~295 flop/byte balance point and K, N >= 256 above
// it.  The backward does twice the forward's flops.
//
// What the design of the kernels below does about it (the bf16 shapes
// of a ResNet-50 step take conv_bn_sm90.cu's wgmma/TMA kernels instead):
//   * bf16 products run on the tensor cores through WMMA 16x16x16 with
//     f32 accumulators (four warps, a 64 x 64 output tile, 32 of depth
//     staged in shared memory at a time); f32 inputs run plain FMAs;
//   * the fold is applied while the x tile is staged, so xh never
//     reaches device memory; the BN statistics come out of the epilogue
//     of the tile that holds y, so y is not read again;
//   * the TPU kernels carry sums in scratch across a sequential grid.
//     Here CTAs run in parallel in no order, so each CTA writes its
//     partial sums (per M tile, or per M split for dw) to a workspace
//     and a small second launch adds them in a fixed order: no float
//     atomics, and a rerun is bit for bit the same;
//   * the backward's ytot is formed while the dx kernel stages it; the
//     CTAs of the first K tile also store it (bf16) for the dw kernel.
//
// Launches per call: forward 2 (product + statistics; reduce), backward
// 3 (dx + ytot; dw partials over M splits; reduce of dw, da and db).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // four warps, each a 32 x 32 quarter of the tile
constexpr int kTile = 64;      // output tile: 64 x 64
constexpr int kDepth = 32;     // depth of one staged chunk
constexpr int kLdC = kTile + 4;  // f32 epilogue tile stride
constexpr int kTargetCtas = 2112;  // dw kernel: two waves of 8 CTAs on each of 132 SMs
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 8;

typedef __nv_bfloat16 bf16;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  __device__ static float f32(float x) { return x; }
  __device__ static float from(float x) { return x; }
};
template <> struct Cvt<bf16> {
  __device__ static float f32(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from(float x) { return __float2bfloat16_rn(x); }
};

// Shared-memory stride of a staged tile with `cols` columns: 16-bit
// tiles pad by 8 elements (WMMA wants 16-byte multiples and 32-byte
// aligned fragment corners), f32 tiles by 4.
template <typename S, int cols>
struct Ld {
  static constexpr int value = cols + (std::is_same<S, float>::value ? 4 : 8);
};

// The 64 x 64 f32 accumulator of one CTA: C += A (64 x 32) . B (32 x 64)
// from shared memory, with A(i, k) = ACOL ? sA[k*lda + i] : sA[i*lda + k]
// and B(k, j) = BCOL ? sB[j*ldb + k] : sB[k*ldb + j].
template <typename S, bool ACOL, bool BCOL> struct Acc;

template <bool ACOL, bool BCOL>
struct Acc<bf16, ACOL, BCOL> {
  using LA = typename std::conditional<ACOL, nvcuda::wmma::col_major,
                                       nvcuda::wmma::row_major>::type;
  using LB = typename std::conditional<BCOL, nvcuda::wmma::col_major,
                                       nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ void mma(const bf16* sA, int lda, const bf16* sB, int ldb) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
    for (int k = 0; k < kDepth; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i;
        wmma::load_matrix_sync(a[i], ACOL ? sA + k * lda + r : sA + r * lda + k, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c0 = wn + 16 * j;
        wmma::load_matrix_sync(b[j], BCOL ? sB + c0 * ldb + k : sB + k * ldb + c0, ldb);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* sC) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(sC + (wm + 16 * i) * kLdC + wn + 16 * j, c[i][j], kLdC,
                                        nvcuda::wmma::mem_row_major);
  }
};

// f32: each thread owns rows tr + 16*r (r < 4) and columns tc + 8*q
// (q < 8) of the tile and sums the depth in order with fmaf.
template <bool ACOL, bool BCOL>
struct Acc<float, ACOL, BCOL> {
  float c[4][8];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) c[r][q] = 0.f;
  }
  __device__ void mma(const float* sA, int lda, const float* sB, int ldb) {
    const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
#pragma unroll 4
    for (int k = 0; k < kDepth; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = tr + 16 * r;
        av[r] = ACOL ? sA[k * lda + i] : sA[i * lda + k];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tc + 8 * q;
        bv[q] = BCOL ? sB[j * ldb + k] : sB[k * ldb + j];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) c[r][q] = fmaf(av[r], bv[q], c[r][q]);
    }
  }
  __device__ void store(float* sC) {
    const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) sC[(tr + 16 * r) * kLdC + tc + 8 * q] = c[r][q];
  }
};

// The staged type of an operand: bf16 tiles feed WMMA, everything else
// (f32 inputs, and bf16 operands of an f32 product) is staged as f32.
template <typename T> using Staged = typename std::conditional<std::is_same<T, bf16>::value, bf16, float>::type;

// The fold, as the plain version computes it: no contraction.
__device__ inline float fold_pre(float x, float a, float b) { return __fadd_rn(__fmul_rn(x, a), b); }
__device__ inline float fold_xh(float x, float a, float b) {
  const float pre = fold_pre(x, a, b);
  // relu, then the bf16 round of the TPU kernel's .astype(bfloat16)
  return __bfloat162float(__float2bfloat16_rn(pre > 0.f ? pre : 0.f));
}

// rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major (rows, cols)
// matrix into a shared tile of stride LD, through f(row, col); entries
// outside the matrix stage as zeros.
template <int R, int C, int LD, typename S, typename F>
__device__ inline void stage(S* dst, long long r0, int c0, long long rows, int cols, F f) {
  for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const long long gr = r0 + r;
    const int gc = c0 + c;
    float v = 0.f;
    if (gr < rows && gc < cols) v = f(gr, gc);
    dst[r * LD + c] = Cvt<S>::from(v);
  }
}

// ---------------------------------------------------------------------------
// B9: y = xh @ w, with per-tile column sums of y and y*y

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const T* __restrict__ w, T* __restrict__ y,
                   float* __restrict__ part, long long M, int K, int N, int fold) {
  using S = Staged<T>;
  constexpr int LDA = Ld<S, kDepth>::value, LDB = Ld<S, kTile>::value;
  __shared__ __align__(128) char smem[sizeof(S) * (kTile * LDA + kDepth * LDB) + 4 * kTile * kLdC];
  S* sA = reinterpret_cast<S*>(smem);    // x rows: 64 (m) x 32 (k)
  S* sB = sA + kTile * LDA;              // w rows: 32 (k) x 64 (n)
  float* sC = reinterpret_cast<float*>(sB + kDepth * LDB);
  const long long m0 = (long long)blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;

  Acc<S, false, false> acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    if (fold)
      stage<kTile, kDepth, LDA>(sA, m0, k0, M, K, [&](long long r, int c) {
        return fold_xh(Cvt<T>::f32(x[r * K + c]), a[c], b[c]);
      });
    else
      stage<kTile, kDepth, LDA>(sA, m0, k0, M, K,
                                [&](long long r, int c) { return Cvt<T>::f32(x[r * K + c]); });
    stage<kDepth, kTile, LDB>(sB, k0, n0, K, N,
                              [&](long long r, int c) { return Cvt<T>::f32(w[r * N + c]); });
    __syncthreads();
    acc.mma(sA, LDA, sB, LDB);
    __syncthreads();
  }
  acc.store(sC);
  __syncthreads();

  const int rows = (int)min((long long)kTile, M - m0);
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    if (r < rows && n0 + c < N) y[(m0 + r) * N + n0 + c] = Cvt<T>::from(sC[r * kLdC + c]);
  }
  // column sums of this tile, in row order, from the f32 y
  if (threadIdx.x < kTile && n0 + (int)threadIdx.x < N) {
    const int c = threadIdx.x;
    float s = 0.f, q = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = sC[r * kLdC + c];
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
    // part is (tiles, 2N): [s1 | s2] per M tile
    float* row = part + (size_t)blockIdx.x * 2 * N;
    row[n0 + c] = s;
    row[N + n0 + c] = q;
  }
}

// ---------------------------------------------------------------------------
// B10, launch 1: dx (grid M tiles x K tiles, contracting over N), with
// the per-M-tile column sums of dxm*x and dxm; ytot stored by K tile 0

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bn_dx_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const T* __restrict__ w,
                  const T* __restrict__ y, const T* __restrict__ dy,
                  const float* __restrict__ ds1, const float* __restrict__ ds2,
                  T* __restrict__ dx, bf16* __restrict__ ytot, float* __restrict__ part,
                  long long M, int K, int N, int fold) {
  using S = Staged<T>;
  constexpr int LD = Ld<S, kDepth>::value;
  __shared__ __align__(128) char smem[sizeof(S) * 2 * kTile * LD + 4 * kTile * kLdC];
  S* sA = reinterpret_cast<S*>(smem);  // ytot rows: 64 (m) x 32 (n)
  S* sB = sA + kTile * LD;             // w rows: 64 (k) x 32 (n)
  float* sC = reinterpret_cast<float*>(sB + kTile * LD);
  const long long m0 = (long long)blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const bool store_ytot = blockIdx.y == 0;

  Acc<S, false, true> acc;
  acc.zero();
  for (int n0 = 0; n0 < N; n0 += kDepth) {
    stage<kTile, kDepth, LD>(sA, m0, n0, M, N, [&](long long r, int c) {
      const size_t i = (size_t)r * N + c;
      const float t = __fadd_rn(__fadd_rn(Cvt<T>::f32(dy[i]), ds1[c]),
                                __fmul_rn(__fmul_rn(2.f, Cvt<T>::f32(y[i])), ds2[c]));
      const bf16 tb = __float2bfloat16_rn(t);
      if (store_ytot) ytot[i] = tb;
      return __bfloat162float(tb);
    });
    stage<kTile, kDepth, LD>(sB, k0, n0, K, N,
                             [&](long long r, int c) { return Cvt<T>::f32(w[r * N + c]); });
    __syncthreads();
    acc.mma(sA, LD, sB, LD);
    __syncthreads();
  }
  acc.store(sC);
  __syncthreads();

  const int rows = (int)min((long long)kTile, M - m0);
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    if (r >= rows || k0 + c >= K) continue;
    const size_t i = (size_t)(m0 + r) * K + k0 + c;
    const float dxh = sC[r * kLdC + c];
    if (fold) {
      const float av = a[k0 + c];
      const float pre = fold_pre(Cvt<T>::f32(x[i]), av, b[k0 + c]);
      const float dxm = __fmul_rn(dxh, pre > 0.f ? 1.f : 0.f);
      sC[r * kLdC + c] = dxm;
      dx[i] = Cvt<T>::from(__fmul_rn(dxm, av));
    } else {
      dx[i] = Cvt<T>::from(dxh);
    }
  }
  if (!fold) return;
  __syncthreads();
  if (threadIdx.x < kTile && k0 + (int)threadIdx.x < K) {
    const int c = threadIdx.x;
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float dxm = sC[r * kLdC + c];
      sa = __fadd_rn(sa, __fmul_rn(dxm, Cvt<T>::f32(x[(size_t)(m0 + r) * K + k0 + c])));
      sb = __fadd_rn(sb, dxm);
    }
    // part is (tiles, 2K): [da | db] per M tile
    float* row = part + (size_t)blockIdx.x * 2 * K;
    row[k0 + c] = sa;
    row[K + k0 + c] = sb;
  }
}

// ---------------------------------------------------------------------------
// B10, launch 2: dw partials, grid K tiles x N tiles x M splits; split s
// sums rows [s*rows_per, (s+1)*rows_per) into part[s] (K x N)

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bn_dw_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const bf16* __restrict__ ytot,
                  float* __restrict__ part, long long M, int K, int N, int fold,
                  long long rows_per) {
  using S = Staged<T>;
  constexpr int LD = Ld<S, kTile>::value;
  __shared__ __align__(128) char smem[sizeof(S) * 2 * kDepth * LD + 4 * kTile * kLdC];
  S* sA = reinterpret_cast<S*>(smem);  // x rows: 32 (m) x 64 (k)
  S* sB = sA + kDepth * LD;            // ytot rows: 32 (m) x 64 (n)
  float* sC = reinterpret_cast<float*>(sB + kDepth * LD);
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const long long r_begin = (long long)blockIdx.z * rows_per;
  const long long r_end = min(M, r_begin + rows_per);

  Acc<S, true, false> acc;
  acc.zero();
  for (long long m0 = r_begin; m0 < r_end; m0 += kDepth) {
    if (fold)
      stage<kDepth, kTile, LD>(sA, m0, k0, r_end, K, [&](long long r, int c) {
        return fold_xh(Cvt<T>::f32(x[r * K + c]), a[c], b[c]);
      });
    else
      stage<kDepth, kTile, LD>(sA, m0, k0, r_end, K,
                               [&](long long r, int c) { return Cvt<T>::f32(x[r * K + c]); });
    stage<kDepth, kTile, LD>(sB, m0, n0, r_end, N, [&](long long r, int c) {
      return __bfloat162float(ytot[r * N + c]);
    });
    __syncthreads();
    acc.mma(sA, LD, sB, LD);
    __syncthreads();
  }
  acc.store(sC);
  __syncthreads();
  float* out = part + (size_t)blockIdx.z * K * N;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    if (k0 + r < K && n0 + c < N) out[(size_t)(k0 + r) * N + n0 + c] = sC[r * kLdC + c];
  }
}

// ---------------------------------------------------------------------------
// Fixed-order column sums: out[c] = sum_r part[r * cols + c].  Thread
// (tx, ty) of a 32 x 8 CTA sums rows ty, ty + 8, ... of column
// blockIdx.x * 32 + tx in order; row 0 of the CTA then adds the eight
// in order.  One launch may serve two problems: CTAs past `blocks1`
// reduce (part2, rows2, cols2) into out2.

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
colsum_kernel(const float* __restrict__ part1, long long rows1, long long cols1,
              float* __restrict__ out1, long long blocks1, const float* __restrict__ part2,
              long long rows2, long long cols2, float* __restrict__ out2) {
  __shared__ float sums[kReduceRows][kReduceCols];
  long long blk = blockIdx.x;
  const float* part = part1;
  long long rows = rows1, cols = cols1;
  float* out = out1;
  if (blk >= blocks1) {
    blk -= blocks1;
    part = part2;
    rows = rows2;
    cols = cols2;
    out = out2;
  }
  const long long c = blk * kReduceCols + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 8
    for (long long r = threadIdx.y; r < rows; r += kReduceRows) s = __fadd_rn(s, part[r * cols + c]);
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = sums[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kReduceRows; ++j) t = __fadd_rn(t, sums[j][threadIdx.x]);
    out[c] = t;
  }
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// M rows of each dw split: a multiple of the staged depth, so that about
// kTargetCtas CTAs run (never fewer splits than one).
long long dw_rows_per(long long M, int K, int N) {
  const long long tiles = cdiv(K, kTile) * cdiv(N, kTile);
  const long long chunks = cdiv(M, kDepth);
  long long splits = cdiv(kTargetCtas, tiles);
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  return cdiv(chunks, splits) * kDepth;
}

cudaError_t launch_colsum(const float* p1, long long r1, long long c1, float* o1,
                          const float* p2, long long r2, long long c2, float* o2,
                          cudaStream_t s) {
  const long long b1 = cdiv(c1, kReduceCols), b2 = p2 ? cdiv(c2, kReduceCols) : 0;
  if (b1 + b2 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  colsum_kernel<<<(unsigned)(b1 + b2), dim3(kReduceCols, kReduceRows), 0, s>>>(
      p1, r1, c1, o1, b1, p2, r2, c2, o2);
  return cudaGetLastError();
}

struct Fwd {
  const void *x, *w;
  const float *a, *b;
  void* y;
  float *s12, *ws;
};

struct Bwd {
  const void *x, *w, *y, *dy;
  const float *a, *b, *ds1, *ds2;
  void* dx;
  float *dw, *dab, *ws;
  bf16* ytot;
};

template <typename T>
cudaError_t fwd(const Fwd& f, long long M, int K, int N, int fold, cudaStream_t s) {
  const long long tiles = cdiv(M, kTile);
  if (tiles > 0x7fffffffLL || cdiv(N, kTile) > 65535) return cudaErrorInvalidConfiguration;
  conv_bn_fwd_kernel<T><<<dim3((unsigned)tiles, (unsigned)cdiv(N, kTile)), kThreads, 0, s>>>(
      static_cast<const T*>(f.x), f.a, f.b, static_cast<const T*>(f.w), static_cast<T*>(f.y),
      f.ws, M, K, N, fold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // ws is (tiles, 2N) of per-tile [s1 | s2]
  return launch_colsum(f.ws, tiles, 2LL * N, f.s12, nullptr, 0, 0, nullptr, s);
}

template <typename T>
cudaError_t bwd(const Bwd& g, long long M, int K, int N, int fold, cudaStream_t s) {
  const long long tiles = cdiv(M, kTile);
  const long long rows_per = dw_rows_per(M, K, N);
  const long long splits = cdiv(M, rows_per);
  if (tiles > 0x7fffffffLL || cdiv(K, kTile) > 65535 || cdiv(N, kTile) > 65535 || splits > 65535)
    return cudaErrorInvalidConfiguration;
  float* dw_part = g.ws;
  float* dab_part = g.ws + (size_t)splits * K * N;
  conv_bn_dx_kernel<T><<<dim3((unsigned)tiles, (unsigned)cdiv(K, kTile)), kThreads, 0, s>>>(
      static_cast<const T*>(g.x), g.a, g.b, static_cast<const T*>(g.w), static_cast<const T*>(g.y),
      static_cast<const T*>(g.dy), g.ds1, g.ds2, static_cast<T*>(g.dx), g.ytot, dab_part, M, K, N,
      fold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv_bn_dw_kernel<T><<<dim3((unsigned)cdiv(K, kTile), (unsigned)cdiv(N, kTile), (unsigned)splits),
                         kThreads, 0, s>>>(static_cast<const T*>(g.x), g.a, g.b, g.ytot, dw_part, M,
                                           K, N, fold, rows_per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dw = sum over splits; [da | db] = sum over M tiles (fold only)
  return launch_colsum(dw_part, splits, (long long)K * N, g.dw, fold ? dab_part : nullptr,
                       tiles, 2LL * K, g.dab, s);
}

// dtype codes shared with ops/conv_bn.py
enum { kF32 = 0, kBF16 = 2 };

bool sm90_route(int dtype, int K, int N) { return dtype == kBF16 && K % 64 == 0 && N % 64 == 0; }

}  // namespace

// conv_bn_sm90.cu
void hvd_conv_bn_sm90_plan(long long M, int K, int N, long long* out);
void hvd_conv_bn_sm90_workspace(long long M, int K, int N, long long* fwd_floats,
                                long long* bwd_floats);
cudaError_t hvd_conv_bn_fwd_sm90(const void* x, const float* a, const float* b, const void* w,
                                 void* y, float* s12, float* ws, long long M, int K, int N,
                                 bool fold, cudaStream_t s);
cudaError_t hvd_conv_bn_bwd_sm90(const void* x, const float* a, const float* b, const void* w,
                                 const void* y, const void* dy, const float* ds1,
                                 const float* ds2, void* dxp, float* dwp, float* dab, void* ytot,
                                 float* ws, long long M, int K, int N, bool fold,
                                 cudaStream_t s);

extern "C" {

// The route of a problem (1: conv_bn_sm90.cu, 0: the WMMA kernels) in
// out[0] and, on the sm90 route, its plan in out[1..12]
// (hvd_conv_bn_sm90_plan).
void hvd_conv_bn_plan(int dtype, long long M, int K, int N, long long* out) {
  out[0] = sm90_route(dtype, K, N);
  if (out[0]) hvd_conv_bn_sm90_plan(M, K, N, out + 1);
}

// Workspace sizes in f32 elements for an (M, K) x (K, N) problem in
// `dtype`: on the WMMA route the forward's per-tile statistics (tiles x
// 2N) and the backward's dw partials (splits x K x N) followed by the
// per-tile da/db (tiles x 2K); on the sm90 route per CTA row instead of
// per tile (hvd_conv_bn_sm90_workspace).
void hvd_conv_bn_workspace(int dtype, long long M, int K, int N, long long* fwd_floats,
                           long long* bwd_floats) {
  if (sm90_route(dtype, K, N)) {
    hvd_conv_bn_sm90_workspace(M, K, N, fwd_floats, bwd_floats);
    return;
  }
  const long long tiles = cdiv(M, kTile);
  const long long splits = cdiv(M, dw_rows_per(M, K, N));
  *fwd_floats = tiles * 2LL * N;
  *bwd_floats = splits * (long long)K * N + tiles * 2LL * K;
}

// All tensors contiguous on `device` (16-byte aligned on the sm90 route).
// x (M, K) and w (K, N) in `dtype`;
// a, b (K,) f32; y (M, N) in `dtype`; s12 (2N,) f32 receives [s1 | s2];
// ws as hvd_conv_bn_workspace says.  Returns the cudaError_t of the
// launches.
int hvd_conv_bn_fwd(int device, int dtype, const void* x, const float* a, const float* b,
                    const void* w, void* y, float* s12, float* ws, long long M, int K, int N,
                    int fold, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  Fwd f{x, w, a, b, y, s12, ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sm90_route(dtype, K, N))
    return (int)hvd_conv_bn_fwd_sm90(x, a, b, w, y, s12, ws, M, K, N, fold != 0, s);
  switch (dtype) {
    case kF32: return (int)fwd<float>(f, M, K, N, fold, s);
    case kBF16: return (int)fwd<bf16>(f, M, K, N, fold, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, w, y, dy, dx in `dtype`; ds1, ds2 (N,) f32; dw (K, N) f32; dab
// (2K,) f32 receives [da | db] (left alone without fold); ytot (M, N)
// bf16 scratch; ws as hvd_conv_bn_workspace says.
int hvd_conv_bn_bwd(int device, int dtype, const void* x, const float* a, const float* b,
                    const void* w, const void* y, const void* dy, const float* ds1,
                    const float* ds2, void* dx, float* dw, float* dab, void* ytot, float* ws,
                    long long M, int K, int N, int fold, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  Bwd g{x, w, y, dy, a, b, ds1, ds2, dx, dw, dab, ws, static_cast<bf16*>(ytot)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sm90_route(dtype, K, N))
    return (int)hvd_conv_bn_bwd_sm90(x, a, b, w, y, dy, ds1, ds2, dx, dw, dab, ytot, ws, M, K, N,
                                     fold != 0, s);
  switch (dtype) {
    case kF32: return (int)bwd<float>(g, M, K, N, fold, s);
    case kBF16: return (int)bwd<bf16>(g, M, K, N, fold, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
