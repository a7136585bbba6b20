// Fused 1x1 convolution + BatchNorm statistics for Hopper, bf16: the
// forward (B9) and the backward (B10), designed around wgmma, a TMA ring
// and register-resident operands.
//
// Replaces, for bf16 problems whose K and N are multiples of 64 (every
// 1x1 convolution of a ResNet-50 step), the Pallas TPU kernels of
// horovod_tpu/ops/pallas_conv_bn.py:
//   conv_bn_fwd_sm90_kernel  <- _fwd_kernel (:85), pallas_call in _fwd_call (:125)
//   conv_bn_dx_sm90_kernel,
//   conv_bn_dw_sm90_kernel   <- _bwd_kernel (:149), pallas_call in _bwd_call (:204)
// conv_bn.cu routes those problems here (f32, and bf16 problems of other
// widths, stay on its WMMA kernels).  A call is 2 launches forward (the
// kernel, then colsum4_kernel over the per-CTA statistics rows) and 3
// backward (dx, dw, then one colsum4_kernel for the dw partials and the
// [da | db] rows).  The functions and casts are conv_bn.cu's:
//
//   forward   xh = fold ? bf16(relu(x*a + b)) : x;  y = f32(xh @ w) -> bf16
//             s1 = sum_rows y, s2 = sum_rows y*y from the f32 y
//   backward  ytot = bf16((dy + ds1) + (2*y)*ds2);  dxh = ytot @ w^T
//             fold: m = (x*a + b > 0), dxm = dxh*m, dx = bf16(dxm*a),
//                   da = sum_rows dxm*x, db = sum_rows dxm;  else dx = bf16(dxh)
//             dw = f32(xh^T @ ytot) over all M
// with every elementwise step one correctly rounded operation
// (__fmul_rn/__fadd_rn, never a contracted fma; RNE casts to bf16).
//
// Bound on this card (NVIDIA H100 SXM): bytes for most ResNet-50 shapes.
// A call moves 2(MK + KN + MN) bytes (forward) or 2(2MK + KN + 2MN) + 4KN
// (backward) against 2MKN or 4MKN flops; below K, N ~ 300 the card's
// ~295 flop/byte balance puts it on the memory side.  So the design
// streams: operands in by TMA, outputs out in full 128-byte rows, and
// nothing else crosses device memory but ytot (written by dx, read by
// dw) and the f32 partial sums.
//
// What the design does about it:
//   * one CTA per SM, persistent: one producer thread keeps a ring of
//     64-deep chunks in flight by TMA (128-byte swizzled boxes, full/empty
//     mbarriers, 3-4 stages), two consumer warpgroups each own 64 rows of
//     a 128-row tile and run wgmma (m64 nW k16, f32 accumulators in
//     registers, setmaxnreg 240/24).  The ring runs on across a CTA's
//     tiles, so the next tile's loads are in flight during this tile's
//     epilogue;
//   * forward: a 128 x BN tile of y (BN <= 256).  Without the fold, x is
//     the K-major shared A operand; with it, each consumer reads its rows
//     of the x chunk with ldmatrix into the register A layout, folds them
//     there and issues wgmma with A in registers: xh never reaches shared
//     or device memory.  w is read MN-major (transpose bit).  Chunk c + 1
//     is folded while chunk c's product runs;
//   * dx: a 128 x BK tile of dx (BK <= 256) contracts over N in 64-wide
//     chunks; ytot is formed in the register A layout from the dy and y
//     chunks (the plain version's operation order) while the previous
//     chunk's product runs; the CTAs of the first K tile store it (bf16)
//     for dw.  ytot is formed K/BK times, at most 8 at K = 2048;
//   * dw: a 128 x BN tile of dw contracts over one split of M; x and ytot
//     are both read MN-major (with the fold, x through ldmatrix.trans into
//     registers and folded there).  Splits fill one wave of 132 CTAs and
//     each sums its rows in its accumulators: the f32 partials are
//     splits x K x N (2.2-16.8 MB a call at the ResNet-50 shapes);
//   * y, dx and ytot leave through a 2 KB staging chunk per warp (the
//     128-byte swizzle, no bank conflicts) as 16-byte stores of whole
//     128-byte rows: stored straight from the accumulator layout (4 bytes
//     a lane, eight rows a warp) they held the forward far from its bound;
//   * statistics (s1, s2; da, db) come from the f32 accumulators in a
//     fixed order: each thread's two rows, a butterfly over the eight lanes
//     that share a column, the eight consumer warps in row order through
//     shared memory, then the CTA's tiles in order; one partial row per
//     CTA, added over the CTAs in colsum_kernel's order.  No float
//     atomics: a rerun repeats every bit;
//   * M tail: TMA reads rows past M as zeros, which the fold turns into
//     relu(b) != 0; such rows are left out of every statistic and store.
//     In dw they meet zero ytot rows, so they add nothing;
//   * the fold and no-fold bodies are template instantiations, never
//     runtime branches around wgmma (ptxas serializes wgmma issued on one
//     conditional path and waited on another).
// The TMA, mbarrier, wgmma and setmaxnreg helpers are file-local copies
// of flash_sm90.cu's, with wgmma wrappers for N = 64, 128, 256 and both
// transpose bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kSms = 132;                         // CTAs of one wave (H100 SXM)
constexpr int kRows = 128;                        // M rows of a forward or dx tile
constexpr int kChunk = 64;                        // depth of a staged chunk: one panel
constexpr int kPanel = 64 * 128;                  // bytes of a 64-row panel

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, named barriers

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

// one box of a 2-D tensor map at (column, row)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// the 256 consumer threads only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// Operands.  A chunk is made of panels: 64 bf16 columns (128 bytes) x rows,
// in the 128-byte swizzle TMA writes (16-byte unit j of row r at j ^ (r % 8)),
// 1024-byte aligned.  A wgmma descriptor: start address >> 4, leading byte
// offset (MN-major: bytes between 64-wide panels), stride byte offset (bytes
// between 8-row groups: 1024), layout 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (its contraction dim contiguous), k step kk (16 columns)
// of one panel: 32 bytes per step
__device__ __forceinline__ uint64_t kmajor(uint32_t panel, int kk) {
  return sw128_desc(panel + kk * 32, 16, 1024);
}
// MN-major operand (contraction dim along the rows), k step kk (16 rows) of
// a chunk of 64-row panels side by side
__device__ __forceinline__ uint64_t mnmajor(uint32_t chunk, int kk) {
  return sw128_desc(chunk + kk * 16 * 128, kPanel, 1024);
}

// ldmatrix address of lane `lane` for the register A fragment of k step kk
// over rows r0 .. r0 + 15 of a panel (matrices: rows 0-7 | 8-15 at columns
// 0-7, then the same at columns 8-15: registers a0 .. a3 of the layout)
__device__ __forceinline__ uint32_t frag_addr(uint32_t panel, int r0, int kk, int lane) {
  const int q = lane / 8, r = r0 + (q % 2) * 8 + lane % 8, j = 2 * kk + q / 2;
  return panel + r * 128 + ((j ^ (r % 8)) << 4);
}
// the same for A = panel^T: A rows are the panel's columns c0 .. c0 + 15, A's
// k step kk its rows 16kk .. 16kk + 15 (read with ldmatrix.trans)
__device__ __forceinline__ uint32_t frag_addr_t(uint32_t panel, int c0, int kk, int lane) {
  const int q = lane / 8, r = 16 * kk + (q / 2) * 8 + lane % 8, j = c0 / 8 + q % 2;
  return panel + r * 128 + ((j ^ (r % 8)) << 4);
}
__device__ __forceinline__ void ldsm(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  return __bfloat1622float2(h);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t v;
  memcpy(&v, &h, 4);
  return v;
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The fold, as the plain version computes it: no contraction
__device__ __forceinline__ float fold_pre(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}
__device__ __forceinline__ float fold_xh(float x, float a, float b) {
  const float pre = fold_pre(x, a, b);
  return __bfloat162float(__float2bfloat16_rn(pre > 0.f ? pre : 0.f));
}
// a bf16 pair folded with per-element (a, b)
__device__ __forceinline__ uint32_t fold2(uint32_t v, float2 a, float2 b) {
  const float2 x = unpack(v);
  return pack(fold_xh(x.x, a.x, b.x), fold_xh(x.y, a.y, b.y));
}
// ytot of a (dy, y) bf16 pair at columns with (ds1, ds2)
__device__ __forceinline__ uint32_t ytot2(uint32_t dyv, uint32_t yv, float2 s1, float2 s2) {
  const float2 d = unpack(dyv), y = unpack(yv);
  return pack(__fadd_rn(__fadd_rn(d.x, s1.x), __fmul_rn(__fmul_rn(2.f, y.x), s2.x)),
              __fadd_rn(__fadd_rn(d.y, s1.y), __fmul_rn(__fmul_rn(2.f, y.y), s2.y)));
}

// ---------------------------------------------------------------------------
// wgmma.  A thread's m64 nW f32 accumulator register i holds row
// warp*16 + lane/4 + 8*half_of(i) and column col_of(i) + (lane % 4)*2 of
// its warpgroup's 64 x W tile.

__device__ __forceinline__ int half_of(int i) { return (i / 2) % 2; }
__device__ __forceinline__ int col_of(int i) { return (i / 4) * 8 + (i % 2); }

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

__device__ __forceinline__ void copy_frags(uint32_t (&d)[4][4], const uint32_t (&s)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[kk][r] = s[kk][r];
}

// D (+)= A . B, bf16 operands, f32 D; TA / TB: the A / B operand is
// MN-major (transpose bit); scale_d = 0 overwrites D
template <int N>
struct Wg;

template <>
struct Wg<64> {
  // D(64 x 64) (+)= A(64 x 16) . B(16 x 64), both from shared memory
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D(64 x 64) (+)= A(64 x 16, registers) . B(16 x 64, shared memory)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wg<128> {
  // D(64 x 128) (+)= A(64 x 16) . B(16 x 128), both from shared memory
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D(64 x 128) (+)= A(64 x 16, registers) . B(16 x 128, shared memory)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wg<256> {
  // D(64 x 256) (+)= A(64 x 16) . B(16 x 256), both from shared memory
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}"
        ", %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D(64 x 256) (+)= A(64 x 16, registers) . B(16 x 256, shared memory)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}"
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// Fixed-order column sums of one 128-row tile, for two statistics at once,
// 64 columns at a time.  c1[j], c2[j] hold this thread's sums over its two
// rows (r, r + 8) of column (j / 2) * 8 + cq + j % 2 of a 64-column chunk.
// A butterfly over the eight lanes that share those columns (xor 4, 8, 16)
// leaves each lane the warp's 16-row sums of two columns, which go to
// `red` (8 warps x 2 statistics x W floats).  Once every chunk is there
// (consumers_sync), consumer thread t adds, for value v = t and t + 256
// (statistic v / W, column v % W), the eight warps in row order and that
// to its running sum run[].  The caller syncs the consumers before a
// tile's first chunk too, so that the previous tile's sums have been read.

// one level over c[0 .. L): lanes with `bit` keep the upper half, the
// others the lower, each adding its partner's (lanemask apart) into c[0 .. L/2)
template <int L>
__device__ __forceinline__ void butterfly_stage(float* c, int bit, int lanemask) {
#pragma unroll
  for (int j = 0; j < L / 2; ++j) {
    const float lo = c[j], hi = c[j + L / 2];
    const float keep = bit ? hi : lo, send = bit ? lo : hi;
    c[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, lanemask));
  }
}

template <int W>
__device__ __forceinline__ void chunk_colsums(float (&c1)[16], float (&c2)[16], float* red,
                                              int col0, int w8, int lane) {
  const int lr = lane / 4, cq = (lane % 4) * 2;
  butterfly_stage<16>(c1, lr & 1, 4);
  butterfly_stage<16>(c2, lr & 1, 4);
  butterfly_stage<8>(c1, (lr >> 1) & 1, 8);
  butterfly_stage<8>(c2, (lr >> 1) & 1, 8);
  butterfly_stage<4>(c1, (lr >> 2) & 1, 16);
  butterfly_stage<4>(c2, (lr >> 2) & 1, 16);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int jo = j + ((lr >> 2) & 1) * 2 + ((lr >> 1) & 1) * 4 + (lr & 1) * 8;
    const int col = col0 + (jo / 2) * 8 + cq + jo % 2;
    red[(w8 * 2) * W + col] = c1[j];
    red[(w8 * 2 + 1) * W + col] = c2[j];
  }
}

template <int W>
__device__ __forceinline__ void finish_colsums(const float* red, float (&run)[2]) {
  consumers_sync();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int v = threadIdx.x + 256 * q;
    if (v < 2 * W) {
      float s = red[v];  // warp 0: red[(0 * 2 + v / W) * W + v % W] = red[v]
#pragma unroll
      for (int w = 1; w < 8; ++w) s = __fadd_rn(s, red[w * 2 * W + v]);
      run[q] = __fadd_rn(run[q], s);
    }
  }
}

// one CTA's running sums into its row of the partials (rows x 2 * total):
// statistic st at columns [st * total + c0, st * total + c0 + W)
template <int W>
__device__ __forceinline__ void store_run(const float (&run)[2], float* row, int total, int c0) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int v = threadIdx.x + 256 * q;
    if (v < 2 * W) row[(v / W) * total + c0 + v % W] = run[q];
  }
}

template <int W>
constexpr int kRed = 8 * 2 * W * 4;
constexpr int kOut = 8 * 16 * 128;  // each consumer warp's 16 x 64 bf16 out-staging chunk

// A warp's 16 x 64 bf16 chunk to rows r0 .. r0 + 15 (those below M) and
// columns c0 .. c0 + 63 of a row-major matrix of `ld` columns; word
// wd[g][h] of this thread is row lane/4 + 8h, columns 8g + (lane % 4) * 2
// and the next.  It goes through the warp's 2 KB of shared memory (the
// 128-byte swizzle: no bank conflicts either way), so that each row leaves
// as 128 contiguous bytes in 16-byte stores.
__device__ __forceinline__ void store_chunk(const uint32_t (&wd)[8][2], char* buf, bf16* out,
                                            int r0, int M, int ld, int c0, int lane) {
  const int lr = lane / 4;
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(buf + (lr + 8 * h) * 128 + ((g ^ lr) << 4) + (lane % 4) * 4) =
          wd[g][h];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * i + lane / 8, j = lane % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(buf + r * 128 + ((j ^ (r % 8)) << 4));
    if (r0 + r < M) *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * ld + c0 + 8 * j) = v;
  }
  __syncwarp();
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages,
                                          uint32_t consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the producer's wait for stage it % ST to be free, and its arrival
template <int ST>
__device__ __forceinline__ char* claim(char* ring, int stage_bytes, uint64_t* full,
                                       uint64_t* empty, int it, uint32_t bytes) {
  const int s = it % ST;
  if (it >= ST) mbar_wait(&empty[s], (it / ST - 1) & 1);
  mbar_expect_tx(&full[s], bytes);
  return ring + s * stage_bytes;
}

// ---------------------------------------------------------------------------
// B9: y = xh @ w with the CTA's column sums of y and y*y.  CTA (p, nt) of
// P x Nt (nt fastest) owns columns [nt * BN, nt * BN + BN) and walks the
// 128-row tiles p, p + P, ...; its [s1 | s2] row goes to part[p].

template <int BN>
struct FwdCfg {
  static constexpr int kStages = 4;
  static constexpr int kX = kRows * 128;   // x chunk: 128 rows x 64 k
  static constexpr int kW = kChunk * BN * 2;  // w chunk: 64 k x BN n, BN / 64 panels
  static constexpr int kStage = kX + kW;
  static constexpr size_t kSmem = 1024 + kStages * kStage + kRed<BN> + kOut + 16 * kStages;
};

template <bool FOLD, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                        const float* __restrict__ a, const float* __restrict__ b,
                        bf16* __restrict__ y, float* __restrict__ part, int M, int K, int N,
                        int P) {
  using C = FwdCfg<BN>;
  constexpr int ST = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* ring = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(ring + ST * C::kStage);
  char* obuf = ring + ST * C::kStage + kRed<BN>;  // + 2 KB per consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + kOut);
  uint64_t* empty = full + ST;

  const int Nt = N / BN, nt = blockIdx.x % Nt, p = blockIdx.x / Nt, n0 = nt * BN;
  const int Mt = (M + kRows - 1) / kRows, chunks = K / kChunk;
  init_ring(full, empty, ST, kConsumers * 128);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int mt = p; mt < Mt; mt += P)
        for (int c = 0; c < chunks; ++c, ++it) {
          char* st = claim<ST>(ring, C::kStage, full, empty, it, C::kStage);
          uint64_t* bar = &full[it % ST];
          tma_load(st, &tx, bar, c * kChunk, mt * kRows);
          for (int q = 0; q < BN / 64; ++q)
            tma_load(st + C::kX + q * kPanel, &tw, bar, n0 + 64 * q, c * kChunk);
        }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int w8 = wg * 4 + warp, lr = lane / 4, cq = (lane % 4) * 2;
  float run[2] = {0.f, 0.f};
  float acc[BN / 2];
  int it = 0;
  // xh of chunk c (ring iteration i) in the register A layout
  auto fold_chunk = [&](int c, int i, uint32_t (&af)[4][4]) {
    mbar_wait(&full[i % ST], (i / ST) & 1);
    const uint32_t xs = smem_u32(ring + (i % ST) * C::kStage);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm(af[kk], frag_addr(xs, wg * 64 + warp * 16, kk, lane));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = c * kChunk + 16 * kk + 8 * e + cq;
        const float2 av = ldg2(a + k), bv = ldg2(b + k);
        af[kk][e * 2] = fold2(af[kk][e * 2], av, bv);
        af[kk][e * 2 + 1] = fold2(af[kk][e * 2 + 1], av, bv);
      }
    }
  };
  for (int mt = p; mt < Mt; mt += P) {
    if constexpr (FOLD) {
      // chunk c's product runs while chunk c + 1 is folded
      uint32_t af[4][4];
      fold_chunk(0, it, af);
      for (int c = 0; c < chunks; ++c, ++it) {
        const uint32_t ws = smem_u32(ring + (it % ST) * C::kStage) + C::kX;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wg<BN>::template rs<1>(acc, af[kk], mnmajor(ws, kk), (c | kk) != 0);
        wg_commit();
        uint32_t nf[4][4];
        if (c + 1 < chunks) fold_chunk(c + 1, it + 1, nf);
        wg_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[it % ST]);
        if (c + 1 < chunks) copy_frags(af, nf);
      }
    } else {
      // chunk c's product runs while chunk c + 1 is waited for and issued
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        const uint32_t xs = smem_u32(ring + s * C::kStage), ws = xs + C::kX;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wg<BN>::template ss<0, 1>(acc, kmajor(xs + wg * 64 * 128, kk), mnmajor(ws, kk),
                                    (c | kk) != 0);
        wg_commit();
        wg_wait<1>();
        if (c > 0) mbar_arrive(&empty[(it - 1) % ST]);
      }
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % ST]);
    }

    // epilogue: y in bf16 and this thread's row-pair sums; rows past M are
    // neither stored nor summed
    const int wrow = mt * kRows + wg * 64 + warp * 16;  // the warp's first row
    const bool in0 = wrow + lr < M, in1 = wrow + lr + 8 < M;
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {
      uint32_t wd[8][2];
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wd[g][h] = pack(acc[32 * q + 4 * g + 2 * h], acc[32 * q + 4 * g + 2 * h + 1]);
      store_chunk(wd, obuf + w8 * 2048, y, wrow, M, N, n0 + 64 * q, lane);
    }
    consumers_sync();  // the previous tile's sums have been read
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {
      float c1[16], c2[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 32 * q + (j / 2) * 4 + j % 2;  // rows r and r + 8: registers i, i + 2
        const float v0 = in0 ? acc[i] : 0.f, v1 = in1 ? acc[i + 2] : 0.f;
        c1[j] = __fadd_rn(v0, v1);
        c2[j] = __fadd_rn(__fmul_rn(v0, v0), __fmul_rn(v1, v1));
      }
      chunk_colsums<BN>(c1, c2, red, 64 * q, w8, lane);
    }
    finish_colsums<BN>(red, run);
  }
  store_run<BN>(run, part + (size_t)p * 2 * N, N, n0);
}

// ---------------------------------------------------------------------------
// B10, launch 1: dx = ytot @ w^T (+ the fold's mask and scale) with the
// CTA's column sums of dxm*x and dxm.  CTA (p, kt) of P x Kt owns columns
// [kt * BK, kt * BK + BK) of dx and walks the 128-row tiles p, p + P, ...,
// contracting over N in 64-wide chunks; CTAs with kt = 0 store ytot.

template <int BK>
struct DxCfg {
  static constexpr int kStages = BK == 256 ? 3 : 4;
  static constexpr int kDy = kRows * 128;  // dy (and y) chunk: 128 rows x 64 n
  static constexpr int kW = BK * 128;      // w chunk: BK k rows x 64 n
  static constexpr int kStage = 2 * kDy + kW;
  static constexpr size_t kSmem = 1024 + kStages * kStage + kRed<BK> + kOut + 16 * kStages;
};

template <bool FOLD, int BK>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_dx_sm90_kernel(const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap ty,
                       const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ ds1, const float* __restrict__ ds2,
                       bf16* __restrict__ dx, bf16* __restrict__ ytot, float* __restrict__ part,
                       int M, int K, int N, int P) {
  using C = DxCfg<BK>;
  constexpr int ST = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* ring = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(ring + ST * C::kStage);
  char* obuf = ring + ST * C::kStage + kRed<BK>;  // + 2 KB per consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + kOut);
  uint64_t* empty = full + ST;

  const int Kt = K / BK, kt = blockIdx.x % Kt, p = blockIdx.x / Kt, k0 = kt * BK;
  const int Mt = (M + kRows - 1) / kRows, chunks = N / kChunk;
  init_ring(full, empty, ST, kConsumers * 128);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int mt = p; mt < Mt; mt += P)
        for (int c = 0; c < chunks; ++c, ++it) {
          char* st = claim<ST>(ring, C::kStage, full, empty, it, C::kStage);
          uint64_t* bar = &full[it % ST];
          tma_load(st, &tdy, bar, c * kChunk, mt * kRows);
          tma_load(st + C::kDy, &ty, bar, c * kChunk, mt * kRows);
          tma_load(st + 2 * C::kDy, &tw, bar, c * kChunk, k0);
        }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int w8 = wg * 4 + warp, lr = lane / 4, cq = (lane % 4) * 2;
  const bool store_ytot = kt == 0;
  float run[2] = {0.f, 0.f};
  float acc[BK / 2];
  int it = 0;
  // ytot of chunk c (ring iteration i) in the register A layout, from the
  // dy and y chunks and ds1, ds2: registers 0, 2 at the thread's first
  // row, 1, 3 eight rows down; 0, 1 at columns n, n + 1 of a k step and
  // 2, 3 at n + 8, n + 9.  The CTAs of
  // the first K tile store it for dw.
  auto ytot_chunk = [&](int c, int i, int wrow, uint32_t (&af)[4][4]) {
    mbar_wait(&full[i % ST], (i / ST) & 1);
    const uint32_t dys = smem_u32(ring + (i % ST) * C::kStage), ys = dys + C::kDy;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t dv[4], yv[4];
      ldsm(dv, frag_addr(dys, wg * 64 + warp * 16, kk, lane));
      ldsm(yv, frag_addr(ys, wg * 64 + warp * 16, kk, lane));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = c * kChunk + 16 * kk + 8 * e + cq;
        const float2 s1 = ldg2(ds1 + n), s2 = ldg2(ds2 + n);
        af[kk][e * 2] = ytot2(dv[e * 2], yv[e * 2], s1, s2);
        af[kk][e * 2 + 1] = ytot2(dv[e * 2 + 1], yv[e * 2 + 1], s1, s2);
      }
    }
    if (store_ytot) {
      const uint32_t wd[8][2] = {{af[0][0], af[0][1]}, {af[0][2], af[0][3]},
                                 {af[1][0], af[1][1]}, {af[1][2], af[1][3]},
                                 {af[2][0], af[2][1]}, {af[2][2], af[2][3]},
                                 {af[3][0], af[3][1]}, {af[3][2], af[3][3]}};
      store_chunk(wd, obuf + w8 * 2048, ytot, wrow, M, N, c * kChunk, lane);
    }
  };
  for (int mt = p; mt < Mt; mt += P) {
    const int wrow = mt * kRows + wg * 64 + warp * 16;  // the warp's first row
    const int row0 = wrow + lr;                         // this thread's rows: row0, row0 + 8
    const bool in0 = row0 < M, in1 = row0 + 8 < M;
    // chunk c's product runs while ytot of chunk c + 1 is formed
    uint32_t af[4][4];
    ytot_chunk(0, it, wrow, af);
    for (int c = 0; c < chunks; ++c, ++it) {
      const uint32_t ws = smem_u32(ring + (it % ST) * C::kStage) + 2 * C::kDy;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wg<BK>::template rs<0>(acc, af[kk], kmajor(ws, kk), (c | kk) != 0);
      wg_commit();
      uint32_t nf[4][4];
      if (c + 1 < chunks) ytot_chunk(c + 1, it + 1, wrow, nf);
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[it % ST]);
      if (c + 1 < chunks) copy_frags(af, nf);
    }

    // epilogue: rows past M are neither stored nor summed
    if constexpr (FOLD) {
      consumers_sync();  // the previous tile's sums have been read
#pragma unroll
      for (int q = 0; q < BK / 64; ++q) {
        uint32_t wd[8][2];
        float c1[16], c2[16];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int gg = 8 * q + g, col = k0 + gg * 8 + cq;
          const float2 av = ldg2(a + col), bv = ldg2(b + col);
          float sa[2][2], sb[2][2];  // [row half][column]: dxm * x and dxm
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            const bool in = h ? in1 : in0;
            const float2 xv =
                in ? unpack(*reinterpret_cast<const uint32_t*>(x + (size_t)row * K + col))
                   : make_float2(0.f, 0.f);
            const float xs[2] = {xv.x, xv.y}, as[2] = {av.x, av.y}, bs[2] = {bv.x, bv.y};
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pre = fold_pre(xs[e], as[e], bs[e]);
              const float dxm = __fmul_rn(acc[4 * gg + 2 * h + e], pre > 0.f ? 1.f : 0.f);
              out[e] = __fmul_rn(dxm, as[e]);
              sb[h][e] = in ? dxm : 0.f;
              sa[h][e] = __fmul_rn(sb[h][e], xs[e]);
            }
            wd[g][h] = pack(out[0], out[1]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            c1[2 * g + e] = __fadd_rn(sa[0][e], sa[1][e]);
            c2[2 * g + e] = __fadd_rn(sb[0][e], sb[1][e]);
          }
        }
        store_chunk(wd, obuf + w8 * 2048, dx, wrow, M, K, k0 + 64 * q, lane);
        chunk_colsums<BK>(c1, c2, red, 64 * q, w8, lane);
      }
      finish_colsums<BK>(red, run);
    } else {
#pragma unroll
      for (int q = 0; q < BK / 64; ++q) {
        uint32_t wd[8][2];
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wd[g][h] = pack(acc[32 * q + 4 * g + 2 * h], acc[32 * q + 4 * g + 2 * h + 1]);
        store_chunk(wd, obuf + w8 * 2048, dx, wrow, M, K, k0 + 64 * q, lane);
      }
    }
  }
  if constexpr (FOLD) store_run<BK>(run, part + (size_t)p * 2 * K, K, k0);
}

// ---------------------------------------------------------------------------
// B10, launch 2: dw partials.  CTA (tile, split) sums rows [split *
// rows_per, split * rows_per + rows_per) of xh^T @ ytot for the 128 x BN
// tile (kt, nt) (nt fastest) into part[split] (K x N); consumer warpgroup g
// owns the tile's k rows [64g, 64g + 64) (a warpgroup past K sits out).

template <int BN>
struct DwCfg {
  static constexpr int kStages = 4;
  static constexpr int kX = 2 * kPanel;   // x chunk: 64 m rows x 128 k (two panels)
  static constexpr int kT = kChunk * BN * 2;  // ytot chunk: 64 m rows x BN n
  static constexpr int kStage = kX + kT;
  static constexpr size_t kSmem = 1024 + kStages * kStage + 16 * kStages;
};

template <bool FOLD, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_dw_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tt,
                       const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ part, int M, int K, int N, int rows_per) {
  using C = DwCfg<BN>;
  constexpr int ST = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * C::kStage);
  uint64_t* empty = full + ST;

  const int Nt = N / BN, kt = blockIdx.x / Nt, nt = blockIdx.x % Nt;
  const int k0 = kt * 128, n0 = nt * BN;
  const int r0 = blockIdx.y * rows_per, chunks = (min(M - r0, rows_per) + kChunk - 1) / kChunk;
  const int active = min(kConsumers, (K - k0) / 64);  // warpgroups with k rows
  init_ring(full, empty, ST, active * 128);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      for (int c = 0; c < chunks; ++c) {
        char* st = claim<ST>(ring, C::kStage, full, empty, c, active * kPanel + C::kT);
        uint64_t* bar = &full[c % ST];
        for (int q = 0; q < active; ++q)
          tma_load(st + q * kPanel, &tx, bar, k0 + 64 * q, r0 + c * kChunk);
        for (int q = 0; q < BN / 64; ++q)
          tma_load(st + C::kX + q * kPanel, &tt, bar, n0 + 64 * q, r0 + c * kChunk);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  if (wg >= active) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int lr = lane / 4, cq = (lane % 4) * 2;
  const int kr = k0 + wg * 64 + warp * 16 + lr;  // this thread's k rows: kr, kr + 8
  float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;
  if constexpr (FOLD) {
    a0 = a[kr];
    b0 = b[kr];
    a1 = a[kr + 8];
    b1 = b[kr + 8];
  }
  float acc[BN / 2];
  if constexpr (FOLD) {
    // xh^T of chunk c in the register A layout (ldmatrix.trans of the x
    // panel, then the fold): registers 0, 2 at k row kr, 1, 3 at kr + 8.
    // Chunk c's product runs while chunk c + 1 is folded.
    auto fold_chunk = [&](int c, uint32_t (&af)[4][4]) {
      mbar_wait(&full[c % ST], (c / ST) & 1);
      const uint32_t xs = smem_u32(ring + (c % ST) * C::kStage) + wg * kPanel;
      const float2 av[2] = {make_float2(a0, a0), make_float2(a1, a1)};
      const float2 bv[2] = {make_float2(b0, b0), make_float2(b1, b1)};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_t(af[kk], frag_addr_t(xs, warp * 16, kk, lane));
#pragma unroll
        for (int r = 0; r < 4; ++r) af[kk][r] = fold2(af[kk][r], av[r % 2], bv[r % 2]);
      }
    };
    uint32_t af[4][4];
    fold_chunk(0, af);
    for (int c = 0; c < chunks; ++c) {
      const uint32_t ts = smem_u32(ring + (c % ST) * C::kStage) + C::kX;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wg<BN>::template rs<1>(acc, af[kk], mnmajor(ts, kk), (c | kk) != 0);
      wg_commit();
      uint32_t nf[4][4];
      if (c + 1 < chunks) fold_chunk(c + 1, nf);
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[c % ST]);
      if (c + 1 < chunks) copy_frags(af, nf);
    }
  } else {
    // chunk c's product runs while chunk c + 1 is waited for and issued
    for (int c = 0; c < chunks; ++c) {
      const int s = c % ST;
      mbar_wait(&full[s], (c / ST) & 1);
      const uint32_t xs = smem_u32(ring + s * C::kStage) + wg * kPanel,
                     ts = smem_u32(ring + s * C::kStage) + C::kX;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wg<BN>::template ss<1, 1>(acc, mnmajor(xs, kk), mnmajor(ts, kk), (c | kk) != 0);
      wg_commit();
      wg_wait<1>();
      if (c > 0) mbar_arrive(&empty[(c - 1) % ST]);
    }
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(chunks - 1) % ST]);
  }

  float* out = part + (size_t)blockIdx.y * K * N;
#pragma unroll
  for (int g = 0; g < BN / 8; ++g) {
    const int col = n0 + g * 8 + cq;
    *reinterpret_cast<float2*>(out + (size_t)kr * N + col) = make_float2(acc[4 * g], acc[4 * g + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(kr + 8) * N + col) =
        make_float2(acc[4 * g + 2], acc[4 * g + 3]);
  }
}

// ---------------------------------------------------------------------------
// Fixed-order column sums of the per-CTA rows, in conv_bn.cu colsum_kernel's
// order (per column: eight interleaved row sums, rows j, j + 8, ..., then
// added in order), four columns to a thread.  One launch serves two
// problems: CTAs past `blocks1` reduce (part2, rows2, cols2) into out2.
// Columns are a multiple of 4 and rows 16-byte aligned.

constexpr int kReduceCols = 32, kReduceRows = 8;

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x = __fadd_rn(s.x, v.x);
  s.y = __fadd_rn(s.y, v.y);
  s.z = __fadd_rn(s.z, v.z);
  s.w = __fadd_rn(s.w, v.w);
}

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
colsum4_kernel(const float* __restrict__ part1, long long rows1, long long cols1,
               float* __restrict__ out1, long long blocks1, const float* __restrict__ part2,
               long long rows2, long long cols2, float* __restrict__ out2) {
  __shared__ float4 sums[kReduceRows][kReduceCols];
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
  const long long c = (blk * kReduceCols + threadIdx.x) * 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < cols) {
#pragma unroll 4
    for (long long r = threadIdx.y; r < rows; r += kReduceRows)
      add4(s, *reinterpret_cast<const float4*>(part + r * cols + c));
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float4 t = sums[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kReduceRows; ++j) add4(t, sums[j][threadIdx.x]);
    *reinterpret_cast<float4*>(out + c) = t;
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

// a row-major (rows, cols) bf16 matrix as boxes of 64 columns x box_rows
// rows, 128-byte swizzled; rows past `rows` read as zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                       int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Width of a tile along a dimension of `dim` (a multiple of 64) when
// `rows` 128-row tiles run beside it: the widest of 256, 128, 64 dividing
// it that still gives half a wave of tiles, else 64.
int tile_width(long long rows, int dim) {
  for (int w = 256; w > 64; w /= 2)
    if (dim % w == 0 && rows * (dim / w) >= kSms / 2) return w;
  return 64;
}

// the route's tiling of an (M, K, N) problem; ops/conv_bn.py keeps a copy
// (_sm90_plan) for its error bounds
struct Plan {
  long long mt;                // 128-row tiles of M
  int fwd_bn, fwd_p;           // forward: tile width over N, CTAs per N tile
  int dx_bk, dx_p;             // dx: tile width over K, CTAs per K tile
  int dw_bn, dw_tiles;         // dw: tile width over N, 128 x dw_bn tiles
  long long rows_per, splits;  // dw: rows of M per split, splits
};

Plan make_plan(long long M, int K, int N) {
  Plan p;
  p.mt = cdiv(M, kRows);
  p.fwd_bn = tile_width(p.mt, N);
  p.fwd_p = (int)std::max(1LL, std::min(p.mt, (long long)(kSms / (N / p.fwd_bn))));
  p.dx_bk = tile_width(p.mt, K);
  p.dx_p = (int)std::max(1LL, std::min(p.mt, (long long)(kSms / (K / p.dx_bk))));
  p.dw_bn = N % 256 == 0 ? 256 : N % 128 == 0 ? 128 : 64;
  p.dw_tiles = (int)(cdiv(K, 128) * (N / p.dw_bn));
  const long long chunks = cdiv(M, kChunk);
  const long long splits = std::max(1LL, std::min(chunks, (long long)(kSms / p.dw_tiles)));
  p.rows_per = cdiv(chunks, splits) * kChunk;
  p.splits = cdiv(M, p.rows_per);
  return p;
}

template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool FOLD, int BN>
cudaError_t fwd(const Plan& p, const void* x, const float* a, const float* b, const void* w,
                void* y, float* part, int M, int K, int N, cudaStream_t s) {
  using C = FwdCfg<BN>;
  CUtensorMap tx, tw;
  cudaError_t err;
  if ((err = tensor_map(&tx, x, M, K, kRows)) != cudaSuccess) return err;
  if ((err = tensor_map(&tw, w, K, N, kChunk)) != cudaSuccess) return err;
  auto kernel = conv_bn_fwd_sm90_kernel<FOLD, BN>;
  if ((err = smem_attr(kernel, C::kSmem)) != cudaSuccess) return err;
  kernel<<<p.fwd_p * (N / BN), kThreads, C::kSmem, s>>>(tx, tw, a, b, static_cast<bf16*>(y), part,
                                                         M, K, N, p.fwd_p);
  return cudaGetLastError();
}

template <bool FOLD, int BK>
cudaError_t dx(const Plan& p, const void* x, const float* a, const float* b, const void* w,
               const void* y, const void* dy, const float* ds1, const float* ds2, void* dxp,
               void* ytot, float* part, int M, int K, int N, cudaStream_t s) {
  using C = DxCfg<BK>;
  CUtensorMap tdy, ty, tw;
  cudaError_t err;
  if ((err = tensor_map(&tdy, dy, M, N, kRows)) != cudaSuccess) return err;
  if ((err = tensor_map(&ty, y, M, N, kRows)) != cudaSuccess) return err;
  if ((err = tensor_map(&tw, w, K, N, BK)) != cudaSuccess) return err;
  auto kernel = conv_bn_dx_sm90_kernel<FOLD, BK>;
  if ((err = smem_attr(kernel, C::kSmem)) != cudaSuccess) return err;
  kernel<<<p.dx_p * (K / BK), kThreads, C::kSmem, s>>>(
      tdy, ty, tw, static_cast<const bf16*>(x), a, b, ds1, ds2, static_cast<bf16*>(dxp),
      static_cast<bf16*>(ytot), part, M, K, N, p.dx_p);
  return cudaGetLastError();
}

template <bool FOLD, int BN>
cudaError_t dw(const Plan& p, const void* x, const float* a, const float* b, const void* ytot,
               float* part, int M, int K, int N, cudaStream_t s) {
  using C = DwCfg<BN>;
  CUtensorMap tx, tt;
  cudaError_t err;
  if ((err = tensor_map(&tx, x, M, K, kChunk)) != cudaSuccess) return err;
  if ((err = tensor_map(&tt, ytot, M, N, kChunk)) != cudaSuccess) return err;
  auto kernel = conv_bn_dw_sm90_kernel<FOLD, BN>;
  if ((err = smem_attr(kernel, C::kSmem)) != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.dw_tiles, (unsigned)p.splits), kThreads, C::kSmem, s>>>(
      tx, tt, a, b, part, M, K, N, (int)p.rows_per);
  return cudaGetLastError();
}

// a template's width argument from a runtime width
template <typename F>
cudaError_t by_width(int w, F f) {
  switch (w) {
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t colsum4(const float* p1, long long r1, long long c1, float* o1, const float* p2,
                    long long r2, long long c2, float* o2, cudaStream_t s) {
  const long long per = kReduceCols * 4;
  const long long b1 = cdiv(c1, per), b2 = p2 ? cdiv(c2, per) : 0;
  if (b1 + b2 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  colsum4_kernel<<<(unsigned)(b1 + b2), dim3(kReduceCols, kReduceRows), 0, s>>>(
      p1, r1, c1, o1, b1, p2, r2, c2, o2);
  return cudaGetLastError();
}

bool fits(long long M, int K, int N) {
  return M > 0 && M <= 0x7fffffffLL && K > 0 && N > 0 && K % 64 == 0 && N % 64 == 0;
}

}  // namespace

// The sm90 route's plan, for ops/conv_bn.py's check of its copy:
// {mt, fwd_bn, fwd_p, dx_bk, dx_p, dw_bn, dw_tiles, rows_per, splits,
//  fwd smem, dx smem, dw smem} (the last three: dynamic shared memory of
// the kernels this problem launches, in bytes)
void hvd_conv_bn_sm90_plan(long long M, int K, int N, long long* out) {
  const Plan p = make_plan(M, K, N);
  const long long v[9] = {p.mt, p.fwd_bn, p.fwd_p, p.dx_bk, p.dx_p, p.dw_bn, p.dw_tiles,
                          p.rows_per, p.splits};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  const auto smem = [](int w, int which) -> long long {
    switch (w) {
      case 64: return which == 0 ? FwdCfg<64>::kSmem : which == 1 ? DxCfg<64>::kSmem : DwCfg<64>::kSmem;
      case 128: return which == 0 ? FwdCfg<128>::kSmem : which == 1 ? DxCfg<128>::kSmem : DwCfg<128>::kSmem;
      default: return which == 0 ? FwdCfg<256>::kSmem : which == 1 ? DxCfg<256>::kSmem : DwCfg<256>::kSmem;
    }
  };
  out[9] = smem(p.fwd_bn, 0);
  out[10] = smem(p.dx_bk, 1);
  out[11] = smem(p.dw_bn, 2);
}

// Workspace in f32 elements: the forward's per-CTA [s1 | s2] rows
// (fwd_p x 2N) and the backward's dw partials (splits x K x N) followed
// by the dx CTAs' [da | db] rows (dx_p x 2K).
void hvd_conv_bn_sm90_workspace(long long M, int K, int N, long long* fwd_floats,
                                long long* bwd_floats) {
  const Plan p = make_plan(M, K, N);
  *fwd_floats = (long long)p.fwd_p * 2 * N;
  *bwd_floats = p.splits * K * N + (long long)p.dx_p * 2 * K;
}

// B9 on the route: y and s12 = [s1 | s2] through the per-CTA statistics
// rows in ws; 2 launches.  bf16 x (M, K), w (K, N), y (M, N), f32 a, b
// (K) and s12, all 16-byte aligned; K and N multiples of 64.
cudaError_t hvd_conv_bn_fwd_sm90(const void* x, const float* a, const float* b, const void* w,
                                 void* y, float* s12, float* ws, long long M, int K, int N,
                                 bool fold, cudaStream_t s) {
  if (!fits(M, K, N)) return cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N);
  const cudaError_t err = by_width(p.fwd_bn, [&](auto bn) {
    return fold ? fwd<true, decltype(bn)::value>(p, x, a, b, w, y, ws, (int)M, K, N, s)
                : fwd<false, decltype(bn)::value>(p, x, a, b, w, y, ws, (int)M, K, N, s);
  });
  if (err != cudaSuccess) return err;
  return colsum4(ws, p.fwd_p, 2LL * N, s12, nullptr, 0, 0, nullptr, s);
}

// B10 on the route: dx, dw, and with a fold dab = [da | db]; ytot (M x N
// bf16) is scratch, and ws holds the dw partials (splits x K x N) then the
// dx CTAs' [da | db] rows; 3 launches.
cudaError_t hvd_conv_bn_bwd_sm90(const void* x, const float* a, const float* b, const void* w,
                                 const void* y, const void* dy, const float* ds1,
                                 const float* ds2, void* dxp, float* dwp, float* dab, void* ytot,
                                 float* ws, long long M, int K, int N, bool fold,
                                 cudaStream_t s) {
  if (!fits(M, K, N)) return cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N);
  if (p.splits > 65535) return cudaErrorInvalidConfiguration;
  float* dw_part = ws;
  float* dab_part = ws + (size_t)p.splits * K * N;
  cudaError_t err = by_width(p.dx_bk, [&](auto bk) {
    return fold ? dx<true, decltype(bk)::value>(p, x, a, b, w, y, dy, ds1, ds2, dxp, ytot, dab_part, (int)M, K, N, s)
                : dx<false, decltype(bk)::value>(p, x, a, b, w, y, dy, ds1, ds2, dxp, ytot, dab_part, (int)M, K, N, s);
  });
  if (err != cudaSuccess) return err;
  err = by_width(p.dw_bn, [&](auto bn) {
    return fold ? dw<true, decltype(bn)::value>(p, x, a, b, ytot, dw_part, (int)M, K, N, s)
                : dw<false, decltype(bn)::value>(p, x, a, b, ytot, dw_part, (int)M, K, N, s);
  });
  if (err != cudaSuccess) return err;
  // dw = sum over the splits; [da | db] = sum over the dx CTAs' rows
  return colsum4(dw_part, p.splits, (long long)K * N, dwp, fold ? dab_part : nullptr, p.dx_p,
                 2LL * K, dab, s);
}
