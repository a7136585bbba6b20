// Causal (optionally sliding-window) flash attention for Hopper, 16-bit
// inputs: the forward (B6), the dq backward (B7) and the dk/dv backward
// (B8), designed around wgmma, a TMA/mbarrier ring and register-resident
// scores.
//
// Replaces, for bf16 and f16 inputs at D = 64 and 128, the Pallas TPU
// kernels of horovod_tpu/ops/pallas_kernels.py:
//   flash_fwd_sm90  <- _flash_kernel (:282), called by _flash_fwd_call (:453)
//   flash_dq_sm90   <- _flash_bwd_dq_kernel (:339), pallas_call at :498
//   flash_dkv_sm90  <- _flash_bwd_dkv_kernel (:383), pallas_call at :514
// with the functions, casts and masks of flash_attention.cu (which keeps
// the f32 kernels and calls these for 16-bit inputs): f32 scores
// q.k^T / sqrt(D); p cast to the input dtype before p.v; T(ds) cast
// before the dq product, T(p) and T(ds) before the dv and dk products;
// dq *= scale and dk *= scale at the end; lse = m + log(max(l, 1e-30)) in
// natural log.
//
// Bound on this card (NVIDIA H100 SXM): operations.  Per visible (q, k)
// pair the forward does 4*D flops, dq 6*D and dk/dv 8*D on the tensor
// cores; at the LM's shape (BH 40, S 2048, D 128) that is 42.96, 64.46
// and 85.9 GFLOP, 0.0434, 0.0652 and 0.0869 ms at 989 TFLOP/s, against
// 84, 105 and 127 MB moved (chip_smoke.py's flash_bound_ms).
//
// What the design does about it:
//   * products are wgmma.mma_async (m64 nN k16, f32 accumulators in
//     registers).  Shared operands are TMA tiles in the 128-byte swizzle
//     the descriptors name, read K-major (q.k^T, dO.v^T, k.q^T, v.dO^T)
//     or MN-major (p.v, T(ds).k, T(p^T).dO, T(ds^T).q, transpose bit
//     set); p and ds never leave registers: the f32 accumulator of a score
//     tile is, pair by pair, the register A operand of the next product;
//   * one CTA = two consumer warpgroups + one producer warpgroup (one
//     thread issues TMA; setmaxnreg moves registers to the consumers).
//     K/V (forward, 3 stages; dq, 2 stages) or Q/dO (dk/dv, 2 stages)
//     tiles come through a ring of full/empty mbarriers, so the next
//     tiles' copies are in flight while the current one computes, and the
//     two consumer warpgroups overlap one's elementwise work with the
//     other's products;
//   * forward: a CTA owns 128 query rows (64 per warpgroup) and walks
//     128-key tiles; S, P (bf16/f16 in registers) and O stay in
//     registers.  Each warpgroup issues S_j = Q.K_j^T and then
//     O += P_{j-1}.V_{j-1}, and runs the softmax of S_j while the second
//     product runs.  The online softmax is in the exp2 domain: one FFMA
//     (scale*log2(e) folded in) and one ex2 per score, the row max and
//     sum reduced across the four lanes of a quad.  The softmax's
//     exponentials and their dependent chain, not the products, bound
//     it: hence the bare ex2 (not exp2f) and the overlap with P.V;
//   * dq: a CTA owns 128 query rows (64 per warpgroup), loads Q and dO
//     once and walks 128-key tiles; S = Q.K^T and dP = dO.V^T land in
//     registers, p = exp2(fma(s, scale*log2 e, -lse*log2 e)) with the
//     row's lse and delta held in registers, dS = p (dp - delta) is cast
//     to T pair by pair as the A operand of dQ += T(dS).K (K read MN-major
//     from the panels S read K-major), and dQ accumulates in registers
//     for the whole loop, times scale once at the end;
//   * dk/dv: a CTA owns 128 keys (64 per warpgroup) and walks 64-row
//     query tiles; S^T = K.Q^T and dP^T = V.dO^T land in registers, the
//     query tile's lse (times log2 e) and delta are staged in shared
//     memory by the producer warp, and dK, dV accumulate in registers for
//     the whole loop;
//   * no atomics: each CTA alone writes its rows, so a rerun is bit for
//     bit the same;
//   * only tiles on the causal diagonal, at the window's edge or past S
//     test the mask; interior tiles skip it, and tiles wholly outside the
//     band are skipped (the loop bounds of pallas_kernels.py:323-327 and
//     :426-430).  Masked p is set to 0 explicitly;
//   * the tensor maps are 3-D over (BH, S, D), so a partial last tile
//     reads zeros past S and never the next head's rows;
//   * CTAs are numbered heaviest tile first across all heads.
// Shared memory, D = 128 (D = 64 halves the tiles): forward 32 KB of Q +
// 3 stages x 64 KB of K and V = 224 KB; dq 64 KB of Q and dO + 2 stages x
// 64 KB of K and V = 192 KB (197,672 B with barriers and alignment;
// 99,368 at D 64); dk/dv 64 KB of K and V + 2 stages x 32 KB of Q and dO
// + 1 KB of lse/delta = 129 KB (plus 1 KB for 1024-byte alignment).  One
// 384-thread CTA per SM (registers: 2 x 128 x 240 for the consumers +
// 128 x 24 for the producer; ptxas: 168 at entry, 0 spills, for every
// kernel here).  dq's key tile is 128 wide: S, dP and dQ take 3 x 64 f32
// registers a thread at D 128, and ptxas keeps it free of spills; it ran
// 4% faster than a 64-key tile with 3 stages on the H100.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map (coordinates innermost first: d, row, bh)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int d,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(row), "r"(bh)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
//
// A shared-memory operand is a tile of 64-column panels, each panel rows
// x 128 bytes in the 128-byte swizzle that TMA writes (8-row atoms of
// 1024 bytes, 1024-byte aligned).  Its descriptor: start address >> 4,
// leading byte offset (MN-major: bytes between 64-wide panels; K-major:
// unused) and stride byte offset (bytes between 8-row groups: 1024), and
// layout 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand, k step kk (16 elements) of a tile whose panels hold
// `rows` rows: panel kk / 4, 32 bytes per step inside it
template <int Rows>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * Rows * 128 + (kk % 4) * 32, 16, 1024);
}
// MN-major operand, k step kk (16 rows) of a tile whose panels hold
// `rows` rows
template <int Rows>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, Rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across wgmma waits
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVD_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HVD_ACC32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HVD_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HVD_ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D(64 x N) (+)= A(64 x 16) . B(16 x N), A and B K-major in shared memory
// (scale_d = 0 overwrites D)
#define HVD_SS(N, TY, DREGS, ACC, IA, IB, IS)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " "    \
               DREGS ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"                    \
               : ACC(d)                                                          \
               : "l"(da), "l"(db), "r"(scale_d))
// D(64 x N) += A(64 x 16) . B(16 x N), A in registers (four words of two
// 16-bit values, the mma fragment layout), B MN-major in shared memory
#define HVD_RS(N, TY, DREGS, ACC, IA0, IA1, IA2, IA3, IB, IS)                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " "    \
               DREGS ", {%" IA0 ", %" IA1 ", %" IA2 ", %" IA3 "}, %" IB          \
               ", p, 1, 1, 1;\n}\n"                                              \
               : ACC(d)                                                          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T, int N>
struct Mma;

template <typename T>
struct Mma<T, 64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    if constexpr (kBf16<T>) HVD_SS("64", "bf16", HVD_D32, HVD_ACC32, "32", "33", "34");
    else HVD_SS("64", "f16", HVD_D32, HVD_ACC32, "32", "33", "34");
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (kBf16<T>) HVD_RS("64", "bf16", HVD_D32, HVD_ACC32, "32", "33", "34", "35", "36", "37");
    else HVD_RS("64", "f16", HVD_D32, HVD_ACC32, "32", "33", "34", "35", "36", "37");
  }
};

template <typename T>
struct Mma<T, 128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
    if constexpr (kBf16<T>) HVD_SS("128", "bf16", HVD_D64, HVD_ACC64, "64", "65", "66");
    else HVD_SS("128", "f16", HVD_D64, HVD_ACC64, "64", "65", "66");
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (kBf16<T>) HVD_RS("128", "bf16", HVD_D64, HVD_ACC64, "64", "65", "66", "67", "68", "69");
    else HVD_RS("128", "f16", HVD_D64, HVD_ACC64, "64", "65", "66", "67", "68", "69");
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (kBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// Register i of a thread's m64 nN f32 accumulator holds row
// warp*16 + lane/4 + 8*half(i) and column col(i) + (lane % 4) * 2 of the
// warpgroup's 64 x N tile.  Registers 8kk .. 8kk+7, packed in pairs, are
// the A fragment of k step kk of a product that takes the tile as its A.
__device__ __forceinline__ int half_of(int i) { return (i / 2) % 2; }
__device__ __forceinline__ int col_of(int i) { return (i / 4) * 8 + (i % 2); }

// 2^x on the special function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || qp - kp < window);
}

__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The producer thread's K/V ring (forward and dq): key tiles kt_begin,
// kt_begin + 1, ... of K and V into stage j % ST, each stage refilled once
// the consumers have released it
template <int D, int BK, int ST>
__device__ __forceinline__ void fill_kv_ring(char* sK, char* sV, const CUtensorMap* tk,
                                             const CUtensorMap* tv, uint64_t* full,
                                             uint64_t* empty, int kt_begin, int n_iter, int bh) {
  constexpr int kKV = BK * D * 2;
  for (int j = 0; j < n_iter; ++j) {
    const int s = j % ST;
    if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
    mbar_expect_tx(&full[s], 2 * kKV);
    const int k0 = (kt_begin + j) * BK;
    for (int p = 0; p < D / 64; ++p) {
      tma_load(sK + s * kKV + p * BK * 128, tk, &full[s], p * 64, k0, bh);
      tma_load(sV + s * kKV + p * BK * 128, tv, &full[s], p * 64, k0, bh);
    }
  }
}

// ---------------------------------------------------------------------------
// forward (B6)

template <int D>
struct FwdCfg {
  static constexpr int BQ = 128, BK = 128;  // query rows, key rows of a tile
  static constexpr int kStages = 3;         // K/V tiles in flight
  static constexpr int kQ = BQ * D * 2;     // bytes of the Q tile
  static constexpr int kKV = BK * D * 2;    // bytes of a K or a V tile
  static constexpr size_t kSmem = 1024 + kQ + 2 * kStages * kKV + 8 * (1 + 2 * kStages);
};

// Raw scores of one key tile into p = exp2(s * scale_log2 - m), one FFMA
// and one ex2 each (the running max m lives in the exp2 domain: the
// tile's max over its visible raw scores, scaled once); masked p = 0.
// Updates m and l and returns alpha = exp2(m_old - m_new) per row half.
// On edge tiles `all` is false and each element tests the mask.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool all, int row0, int col0,
                                               int window, float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
  if (all) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[half_of(i)] = fmaxf(mx[half_of(i)], sc[i]);
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const bool vis = visible(row0 + 8 * half_of(i), col0 + col_of(i), window);
      if (vis) mx[half_of(i)] = fmaxf(mx[half_of(i)], sc[i]);
    }
  }
  float nm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h] * scale_log2);
    alpha[h] = ex2(m[h] - mn);
    m[h] = mn;
    nm[h] = -mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float p = ex2(fmaf(sc[i], scale_log2, nm[half_of(i)]));
    if (!all && !visible(row0 + 8 * half_of(i), col0 + col_of(i), window)) p = 0.f;
    sc[i] = p;
    sum[half_of(i)] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                      float* __restrict__ lse, int BH, int S, int window, float scale_log2) {
  using C = FwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sK = sQ + C::kQ;
  char* sV = sK + ST * C::kKV;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + ST * C::kKV);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int n_q = (S + BQ - 1) / BQ, n_k = (S + BK - 1) / BK;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - blockIdx.x / BH) * BQ;  // heaviest tiles first
  const int kt_end = min(n_k, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_iter = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qbar, C::kQ);
      for (int p = 0; p < D / 64; ++p) tma_load(sQ + p * BQ * 128, &tq, qbar, p * 64, q0, bh);
      fill_kv_ring<D, BK, ST>(sK, sV, &tk, &tv, full, empty, kt_begin, n_iter, bh);
    }
    return;
  }

  // consumers.  Iteration j issues S_j = Q.K_j^T and, behind it on the
  // tensor cores, O += P_{j-1}.V_{j-1}; the softmax of S_j runs while
  // that product does, and O is rescaled by alpha_j once it has landed.
  // Every tile of the loop is computed (a tile wholly masked for one
  // warpgroup gives p = 0 there), so no wgmma sits on a divergent path.
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = q0 + wg * 64;                 // this warpgroup's first row
  const int row0 = r0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int cq = (lane % 4) * 2;               // this thread's column offset
  const uint32_t q_tile = smem_u32(sQ) + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pa[BK / 16][4];  // P of the previous tile, the A operand of P.V

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_iter; ++j) {
    const int s = j % ST;
    const int k0 = (kt_begin + j) * BK;
    mbar_wait(&full[s], (j / ST) & 1);
    float sc[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<T, BK>::ss(sc, kmajor<BQ>(q_tile, kk), kmajor<BK>(smem_u32(sK + s * C::kKV), kk),
                     kk > 0);
    wg_commit();
    const int sp = (j + ST - 1) % ST;  // the previous tile's stage
    if (j > 0) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<T, D>::rs(o, pa[kk], mnmajor<BK>(smem_u32(sV + sp * C::kKV), kk));
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    fence_regs(sc);
    const bool all = k0 + BK - 1 <= r0 && (window <= 0 || r0 + 63 - k0 < window);
    float alpha[2];
    online_softmax<BK>(sc, m, l, alpha, all, row0, k0 + cq, window, scale_log2);
    wg_wait<0>();
    fence_regs(o);
    if (j > 0) mbar_arrive(&empty[sp]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[half_of(i)];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) pa[i / 8][(i % 8) / 2] = pack2<T>(sc[i], sc[i + 1]);
  }
  {
    const int sp = (n_iter - 1) % ST;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Mma<T, D>::rs(o, pa[kk], mnmajor<BK>(smem_u32(sV + sp * C::kKV), kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[sp]);
  }

  // epilogue: l summed across the quad; out = o / l, lse = m + log(l)
  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lc[h] = fmaxf(l[h], 1e-30f);
    const int row = row0 + 8 * h;
    if (lane % 4 == 0 && row < S) lse[(size_t)bh * S + row] = m[h] * kLn2 + logf(lc[h]);
  }
  T* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + 8 * half_of(i);
    if (row < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + col_of(i) + cq) =
          pack2<T>(o[i] / lc[half_of(i)], o[i + 1] / lc[half_of(i)]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv (B8)

template <int D>
struct DkvCfg {
  static constexpr int BK = 128, BQ = 64;  // key rows (64 per warpgroup), query rows
  static constexpr int kStages = 2;        // Q/dO tiles in flight
  static constexpr int kKV = BK * D * 2;   // bytes of the K or the V tile
  static constexpr int kQ = BQ * D * 2;    // bytes of a Q or a dO tile
  static constexpr int kRows = 2 * BQ * 4; // lse * log2(e) and delta of a query tile
  static constexpr size_t kSmem =
      1024 + 2 * kKV + kStages * (2 * kQ + kRows) + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int BH, int S, int window,
                      float scale, float scale_log2) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* sK = align1024(smem_raw);
  char* sV = sK + C::kKV;
  char* sQ = sV + C::kKV;
  char* sDO = sQ + ST * C::kQ;
  float* sRows = reinterpret_cast<float*>(sDO + ST * C::kQ);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sRows + ST * 2 * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + ST;

  const int n_q = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BK;  // first key tiles (longest loops) first
  const int qt_begin = k0 / BQ;
  int qt_end = n_q;
  if (window > 0) qt_end = min(qt_end, (k0 + BK - 1 + window - 1) / BQ + 1);
  const int n_iter = qt_end - qt_begin;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  if (wg == kConsumers) {
    // producer warp: K and V once, then per query tile its lse and delta
    // (staged by the 32 lanes) and its Q and dO tiles (TMA, lane 0)
    setmaxnreg_dec<24>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * C::kKV);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(sK + p * BK * 128, &tk, kvbar, p * 64, k0, bh);
          tma_load(sV + p * BK * 128, &tv, kvbar, p * 64, k0, bh);
        }
      }
      const float* lse_b = lse + (size_t)bh * S;
      const float* delta_b = delta + (size_t)bh * S;
      for (int j = 0; j < n_iter; ++j) {
        const int s = j % ST;
        const int q0 = (qt_begin + j) * BQ;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        float* rows = sRows + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const bool in = q0 + i < S;
          rows[i] = in ? lse_b[q0 + i] * kLog2e : 0.f;
          rows[BQ + i] = in ? delta_b[q0 + i] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::kQ);
          for (int p = 0; p < D / 64; ++p) {
            tma_load(sQ + s * C::kQ + p * BQ * 128, &tq, &full[s], p * 64, q0, bh);
            tma_load(sDO + s * C::kQ + p * BQ * 128, &tdo, &full[s], p * 64, q0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c0 = k0 + wg * 64;                 // this warpgroup's first key
  const int key0 = c0 + warp * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const int cq = (lane % 4) * 2;               // this thread's query offset
  const uint32_t k_tile = smem_u32(sK) + wg * 64 * 128;
  const uint32_t v_tile = smem_u32(sV) + wg * 64 * 128;

  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_iter; ++j) {
    const int s = j % ST;
    const int q0 = (qt_begin + j) * BQ;
    mbar_wait(&full[s], (j / ST) & 1);
    const bool none = c0 > q0 + BQ - 1 || (window > 0 && q0 - (c0 + 63) >= window);
    if (!none) {
      const bool all =
          c0 + 63 <= q0 && (window <= 0 || q0 + BQ - 1 - c0 < window) && q0 + BQ <= S;
      const uint32_t q_tile = smem_u32(sQ + s * C::kQ);
      const uint32_t do_tile = smem_u32(sDO + s * C::kQ);
      float st[BQ / 2], dpt[BQ / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<T, BQ>::ss(st, kmajor<BK>(k_tile, kk), kmajor<BQ>(q_tile, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<T, BQ>::ss(dpt, kmajor<BK>(v_tile, kk), kmajor<BQ>(do_tile, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta), both cast
      // to T in registers as the A operands of dV += p^T.dO, dK += ds^T.Q
      const float* rows = sRows + s * 2 * BQ;
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const int c = col_of(i) + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
        const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + c);
        float p0 = ex2(st[i] * scale_log2 - l2.x);
        float p1 = ex2(st[i + 1] * scale_log2 - l2.y);
        if (!all) {
          const int kp = key0 + 8 * half_of(i), qp = q0 + c;
          p0 = qp < S && visible(qp, kp, window) ? p0 : 0.f;
          p1 = qp + 1 < S && visible(qp + 1, kp, window) ? p1 : 0.f;
        }
        pa[i / 8][(i % 8) / 2] = pack2<T>(p0, p1);
        da[i / 8][(i % 8) / 2] = pack2<T>(p0 * (dpt[i] - dl.x), p1 * (dpt[i + 1] - dl.y));
      }

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) Mma<T, D>::rs(dvacc, pa[kk], mnmajor<BQ>(do_tile, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) Mma<T, D>::rs(dkacc, da[kk], mnmajor<BQ>(q_tile, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(dvacc);
      fence_regs(dkacc);
    }
    mbar_arrive(&empty[s]);
  }

  const size_t base = (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key0 + 8 * half_of(i);
    if (key < S) {
      const size_t o = base + (size_t)key * D + col_of(i) + cq;
      *reinterpret_cast<uint32_t*>(dk + o) = pack2<T>(dkacc[i] * scale, dkacc[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack2<T>(dvacc[i], dvacc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq (B7)

template <int D>
struct DqCfg {
  static constexpr int BQ = 128, BK = 128;  // query rows (64 per warpgroup), key rows
  static constexpr int kStages = 2;         // K/V tiles in flight
  static constexpr int kQ = BQ * D * 2;     // bytes of the Q or the dO tile
  static constexpr int kKV = BK * D * 2;    // bytes of a K or a V tile
  static constexpr size_t kSmem = 1024 + 2 * kQ + 2 * kStages * kKV + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, int BH, int S, int window, float scale,
                     float scale_log2) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sDO = sQ + C::kQ;
  char* sK = sDO + C::kQ;
  char* sV = sK + ST * C::kKV;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + ST * C::kKV);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int n_q = (S + BQ - 1) / BQ, n_k = (S + BK - 1) / BK;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - blockIdx.x / BH) * BQ;  // heaviest tiles first
  const int kt_end = min(n_k, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_iter = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread loads Q and dO once, then keeps the K/V ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qbar, 2 * C::kQ);
      for (int p = 0; p < D / 64; ++p) {
        tma_load(sQ + p * BQ * 128, &tq, qbar, p * 64, q0, bh);
        tma_load(sDO + p * BQ * 128, &tdo, qbar, p * 64, q0, bh);
      }
      fill_kv_ring<D, BK, ST>(sK, sV, &tk, &tv, full, empty, kt_begin, n_iter, bh);
    }
    return;
  }

  // consumers: per key tile S = Q.K^T and dP = dO.V^T into registers,
  // p and dS elementwise there, dS cast to T pair by pair as the register
  // A operand of dQ += T(dS).K (K read MN-major from the same panels)
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = q0 + wg * 64;                 // this warpgroup's first row
  const int row0 = r0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int cq = (lane % 4) * 2;               // this thread's key offset in a tile
  const uint32_t q_tile = smem_u32(sQ) + wg * 64 * 128;
  const uint32_t do_tile = smem_u32(sDO) + wg * 64 * 128;

  // -lse * log2(e) and delta of this thread's two rows (0 past S)
  float nl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < S;
    nl[h] = in ? -lse[(size_t)bh * S + row] * kLog2e : 0.f;
    dl[h] = in ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_iter; ++j) {
    const int s = j % ST;
    const int k0 = (kt_begin + j) * BK;
    mbar_wait(&full[s], (j / ST) & 1);
    const bool none = r0 >= S || k0 > r0 + 63 || (window > 0 && r0 - (k0 + BK - 1) >= window);
    if (!none) {
      const bool all = k0 + BK - 1 <= r0 && (window <= 0 || r0 + 63 - k0 < window);
      const uint32_t k_tile = smem_u32(sK + s * C::kKV);
      const uint32_t v_tile = smem_u32(sV + s * C::kKV);
      float sc[BK / 2], dp[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<T, BK>::ss(sc, kmajor<BQ>(q_tile, kk), kmajor<BK>(k_tile, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<T, BK>::ss(dp, kmajor<BQ>(do_tile, kk), kmajor<BK>(v_tile, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // p = exp2(s * scale * log2 e - lse * log2 e), 0 where masked;
      // dS = p (dp - delta), cast to T
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int h = half_of(i);
        float p0 = ex2(fmaf(sc[i], scale_log2, nl[h]));
        float p1 = ex2(fmaf(sc[i + 1], scale_log2, nl[h]));
        if (!all) {
          const int qp = row0 + 8 * h, kp = k0 + col_of(i) + cq;
          p0 = visible(qp, kp, window) ? p0 : 0.f;
          p1 = visible(qp, kp + 1, window) ? p1 : 0.f;
        }
        da[i / 8][(i % 8) / 2] = pack2<T>(p0 * (dp[i] - dl[h]), p1 * (dp[i + 1] - dl[h]));
      }

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) Mma<T, D>::rs(acc, da[kk], mnmajor<BK>(k_tile, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(&empty[s]);
  }

  T* out = dq + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + 8 * half_of(i);
    if (row < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col_of(i) + cq) =
          pack2<T>(acc[i] * scale, acc[i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point lookup (the library is not linked against libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a (BH, S, D) tensor as 3-D boxes of 64 columns x `rows` rows x 1 head,
// 128-byte swizzled; rows past S read as zeros
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int BH, int S, int D, int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T), (cuuint64_t)S * D * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      enc(map, kBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
          const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t grid(int BH, int tiles, unsigned& blocks) {
  const long long n = (long long)BH * tiles;
  if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blocks = (unsigned)n;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int S,
                int window, cudaStream_t stream) {
  using C = FwdCfg<D>;
  unsigned blocks = 0;
  cudaError_t err = grid(BH, (S + C::BQ - 1) / C::BQ, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  CUtensorMap tq, tk, tv;
  if ((err = tensor_map<T>(&tq, q, BH, S, D, C::BQ)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tk, k, BH, S, D, C::BK)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tv, v, BH, S, D, C::BK)) != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));
  kernel<<<blocks, kThreads, C::kSmem, stream>>>(tq, tk, tv, static_cast<T*>(out), lse, BH, S,
                                                  window, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int BH, int S, int window,
                cudaStream_t stream) {
  using C = DkvCfg<D>;
  unsigned blocks = 0;
  cudaError_t err = grid(BH, (S + C::BK - 1) / C::BK, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  CUtensorMap tq, tk, tv, tdo;
  if ((err = tensor_map<T>(&tq, q, BH, S, D, C::BQ)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tk, k, BH, S, D, C::BK)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tv, v, BH, S, D, C::BK)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tdo, dout, BH, S, D, C::BQ)) != cudaSuccess) return err;
  auto kernel = flash_dkv_sm90_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  kernel<<<blocks, kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), BH, S, window, (float)scale,
                                                  (float)(kLog2e * scale));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, int BH, int S, int window, cudaStream_t stream) {
  using C = DqCfg<D>;
  unsigned blocks = 0;
  cudaError_t err = grid(BH, (S + C::BQ - 1) / C::BQ, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  CUtensorMap tq, tk, tv, tdo;
  if ((err = tensor_map<T>(&tq, q, BH, S, D, C::BQ)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tk, k, BH, S, D, C::BK)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tv, v, BH, S, D, C::BK)) != cudaSuccess) return err;
  if ((err = tensor_map<T>(&tdo, dout, BH, S, D, C::BQ)) != cudaSuccess) return err;
  auto kernel = flash_dq_sm90_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  kernel<<<blocks, kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
                                                  BH, S, window, (float)scale,
                                                  (float)(kLog2e * scale));
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_d(int D, const void* q, const void* k, const void* v, void* out, float* lse, int BH,
                  int S, int window, cudaStream_t s) {
  switch (D) {
    case 64: return fwd<T, 64>(q, k, v, out, lse, BH, S, window, s);
    case 128: return fwd<T, 128>(q, k, v, out, lse, BH, S, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_d(int D, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                  int window, cudaStream_t s) {
  switch (D) {
    case 64: return dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S, window, s);
    case 128: return dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dq_d(int D, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq_out, int BH, int S, int window,
                 cudaStream_t s) {
  switch (D) {
    case 64: return dq<T, 64>(q, k, v, dout, lse, delta, dq_out, BH, S, window, s);
    case 128: return dq<T, 128>(q, k, v, dout, lse, delta, dq_out, BH, S, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Called by flash_attention.cu for 16-bit inputs (bf16 when `bf16`, else
// f16); the device is set and the arguments checked there.
cudaError_t hvd_flash_fwd_sm90(bool bf16, int D, const void* q, const void* k, const void* v,
                               void* out, float* lse, int BH, int S, int window,
                               cudaStream_t s) {
  return bf16 ? fwd_d<__nv_bfloat16>(D, q, k, v, out, lse, BH, S, window, s)
              : fwd_d<__half>(D, q, k, v, out, lse, BH, S, window, s);
}

cudaError_t hvd_flash_dkv_sm90(bool bf16, int D, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta, void* dk,
                               void* dv, int BH, int S, int window, cudaStream_t s) {
  return bf16 ? dkv_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk, dv, BH, S, window, s)
              : dkv_d<__half>(D, q, k, v, dout, lse, delta, dk, dv, BH, S, window, s);
}

cudaError_t hvd_flash_dq_sm90(bool bf16, int D, const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta, void* dq,
                              int BH, int S, int window, cudaStream_t s) {
  return bf16 ? dq_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, BH, S, window, s)
              : dq_d<__half>(D, q, k, v, dout, lse, delta, dq, BH, S, window, s);
}
