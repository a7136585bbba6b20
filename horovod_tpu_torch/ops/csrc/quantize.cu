// Block-scaled int8 / int4 wire codec: encode and decode.
//
// Replaces four Pallas kernels of horovod_tpu/ops/pallas_kernels.py:
//   quantize_blockwise        (_quantize_kernel)        -> quantize_blockwise, QMAX 127
//   dequantize_blockwise      (_dequantize_kernel)      -> dequantize_blockwise, INT4 false
//   quantize_blockwise_int4   (_quantize_int4_kernel)   -> quantize_blockwise, QMAX 7
//   dequantize_blockwise_int4 (_dequantize_int4_kernel) -> dequantize_blockwise, INT4 true
// in the layout of the numpy codec (horovod_tpu/ops/quantize.py
// np_quantize_blockwise*): nb = ceil(n / 256) blocks, the ragged last
// block read as zeros.  The Pallas wrappers' padding to 128-block rows
// is a TPU tiling rule and is not reproduced: it would change the bytes
// on the wire.
//
// Encode, per 256-element block:
//     absmax = max |x|                     (a NaN in the block propagates)
//     scale  = f32(bf16_rn(absmax / QMAX))  QMAX = 127 (int8) or 7 (int4)
//     safe   = scale > 0 ? scale : 1
//     q      = clip(rint(x / safe), -QMAX, QMAX), a NaN quotient -> 0
// int4 stores (q + 8) two codes to a byte, even index in the low nibble.
// Decode: out = Out(f32(q) * scale) with a round-to-nearest-even cast.
//
// Every operation is the correctly rounded one the numpy codec makes:
// __fdiv_rn (never a reciprocal or __fdividef), rintf (half to even),
// __float2bfloat16_rn (subnormals included), __fmul_rn.  The build must
// not use --use_fast_math or -ftz=true.  fmaxf would drop a NaN, and a
// NaN gradient would then decode as finite numbers; nan_max keeps it, so
// a block holding NaN gets scale NaN and decodes to all-NaN, and a block
// holding +-inf gets scale inf, encodes the inf as 0 and decodes to
// all-NaN too, as in the reference.
//
// Bound: device-memory bandwidth.  Per element the encode reads the
// input (2 or 4 bytes) and writes 1 or 0.5 byte; the decode reads 1 or
// 0.5 byte and writes 2 or 4; the work is a handful of f32 operations,
// far below the card's operations-per-byte balance point.  The design
// keeps memory busy and nothing more:
//   * encode: one warp per block, 8 consecutive elements per lane read
//     with 16-byte loads; the absmax is a shuffle reduction, so the
//     block is read once and never goes through shared memory; each lane
//     writes its 8 codes with one 8-byte (int8) or 4-byte (int4) store;
//   * decode: 8 elements per thread, one code load and 16-byte stores;
//   * grid-stride loops, so one launch covers any length (the 25.6 M
//     elements of the ResNet-50 gradient included).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;              // elements per scale block
constexpr int kThreads = 256;            // 8 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kBlock / 32;        // 8 elements per lane / thread
constexpr long long kMaxCtas = 4096;

template <typename T> struct Cvt;

template <> struct Cvt<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
};
template <> struct Cvt<__half> {
  __device__ static float load(__half x) { return __half2float(x); }
  __device__ static __half store(float x) { return __float2half_rn(x); }
};
template <> struct Cvt<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// max that keeps a NaN from either side (fmaxf returns the other one)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// kPer consecutive elements from i0, zeros past n; 16-byte loads when
// the base pointer allows and the group is whole
template <typename In>
__device__ __forceinline__ void load_group(const In* __restrict__ x, long long i0,
                                           long long n, bool vec, float v[kPer]) {
  if (vec && i0 + kPer <= n) {
    constexpr int kVecs = kPer * (int)sizeof(In) / 16;
    alignas(16) uint4 raw[kVecs];
    const uint4* src = reinterpret_cast<const uint4*>(x + i0);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) raw[k] = src[k];
    const In* e = reinterpret_cast<const In*>(raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = Cvt<In>::load(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = (i0 + j < n) ? Cvt<In>::load(x[i0 + j]) : 0.f;
  }
}

template <typename In, int QMAX>
__global__ void __launch_bounds__(kThreads)
quantize_blockwise(const In* __restrict__ x, long long n, long long nb,
                   void* __restrict__ codes, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const float qmax = (float)QMAX;
  // the loop count depends on the warp only, so every lane of a warp
  // takes part in every shuffle
  for (long long b = first; b < nb; b += stride) {
    float v[kPer];
    load_group<In>(x, b * kBlock + lane * kPer, n, vec, v);
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) m = nan_max(m, fabsf(v[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(m, qmax)));
    const float safe = scale > 0.f ? scale : 1.f;
    int q[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float t = rintf(__fdiv_rn(v[j], safe));
      t = (t != t) ? 0.f : fminf(fmaxf(t, -qmax), qmax);
      q[j] = (int)t;
    }
    if (QMAX == 127) {
      uint2 w;
      w.x = (uint32_t)(uint8_t)q[0] | ((uint32_t)(uint8_t)q[1] << 8) |
            ((uint32_t)(uint8_t)q[2] << 16) | ((uint32_t)(uint8_t)q[3] << 24);
      w.y = (uint32_t)(uint8_t)q[4] | ((uint32_t)(uint8_t)q[5] << 8) |
            ((uint32_t)(uint8_t)q[6] << 16) | ((uint32_t)(uint8_t)q[7] << 24);
      reinterpret_cast<uint2*>(static_cast<int8_t*>(codes) + b * kBlock)[lane] = w;
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < kPer / 2; ++k) {
        const uint32_t byte = (uint32_t)(q[2 * k] + 8) | ((uint32_t)(q[2 * k + 1] + 8) << 4);
        w |= byte << (8 * k);
      }
      reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(codes) + b * (kBlock / 2))[lane] = w;
    }
    if (lane == 0) scales[b] = scale;
  }
}

template <typename Out, bool INT4>
__global__ void __launch_bounds__(kThreads)
dequantize_blockwise(const void* __restrict__ codes, const float* __restrict__ scales,
                     long long n, Out* __restrict__ out) {
  const long long groups = (n + kPer - 1) / kPer;
  const uintptr_t code_align = INT4 ? 4 : 8;
  const bool vec_in = reinterpret_cast<uintptr_t>(codes) % code_align == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const uint8_t* bytes = static_cast<const uint8_t*>(codes);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const long long i0 = g * kPer;
    // the codes of a group always exist: the code array covers nb whole
    // blocks, and kPer divides kBlock
    const float s = scales[i0 / kBlock];
    int q[kPer];
    if (INT4) {
      uint32_t w;
      if (vec_in) {
        w = reinterpret_cast<const uint32_t*>(bytes)[g];
      } else {
        w = 0;
#pragma unroll
        for (int k = 0; k < kPer / 2; ++k) w |= (uint32_t)bytes[g * (kPer / 2) + k] << (8 * k);
      }
#pragma unroll
      for (int k = 0; k < kPer / 2; ++k) {
        const uint32_t byte = (w >> (8 * k)) & 0xffu;
        q[2 * k] = (int)(byte & 0x0fu) - 8;
        q[2 * k + 1] = (int)(byte >> 4) - 8;
      }
    } else {
      uint2 w;
      if (vec_in) {
        w = reinterpret_cast<const uint2*>(bytes)[g];
      } else {
        w.x = w.y = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w.x |= (uint32_t)bytes[g * kPer + k] << (8 * k);
          w.y |= (uint32_t)bytes[g * kPer + 4 + k] << (8 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        q[k] = (int)(int8_t)((w.x >> (8 * k)) & 0xffu);
        q[4 + k] = (int)(int8_t)((w.y >> (8 * k)) & 0xffu);
      }
    }
    alignas(16) Out y[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) y[j] = Cvt<Out>::store(__fmul_rn((float)q[j], s));
    if (vec_out && i0 + kPer <= n) {
      constexpr int kVecs = kPer * (int)sizeof(Out) / 16;
      const uint4* src = reinterpret_cast<const uint4*>(y);
      uint4* dst = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) dst[k] = src[k];
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (i0 + j < n) out[i0 + j] = y[j];
    }
  }
}

long long ctas_for(long long work, long long per_cta) {
  long long c = (work + per_cta - 1) / per_cta;
  return c < kMaxCtas ? c : kMaxCtas;
}

template <typename In>
cudaError_t launch_quantize(const void* x, long long n, int bits, void* codes,
                            float* scales, cudaStream_t s) {
  const long long nb = (n + kBlock - 1) / kBlock;
  const unsigned grid = (unsigned)ctas_for(nb, kWarps);
  const In* xi = static_cast<const In*>(x);
  if (bits == 8)
    quantize_blockwise<In, 127><<<grid, kThreads, 0, s>>>(xi, n, nb, codes, scales);
  else
    quantize_blockwise<In, 7><<<grid, kThreads, 0, s>>>(xi, n, nb, codes, scales);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t launch_dequantize(const void* codes, const float* scales, long long n,
                              int bits, void* out, cudaStream_t s) {
  const unsigned grid = (unsigned)ctas_for((n + kPer - 1) / kPer, kThreads);
  Out* o = static_cast<Out*>(out);
  if (bits == 4)
    dequantize_blockwise<Out, true><<<grid, kThreads, 0, s>>>(codes, scales, n, o);
  else
    dequantize_blockwise<Out, false><<<grid, kThreads, 0, s>>>(codes, scales, n, o);
  return cudaGetLastError();
}

// dtype codes shared with ops/quantize_kernels.py (and scale_cast.cu)
enum { kF32 = 0, kF16 = 1, kBF16 = 2 };

}  // namespace

extern "C" {

// x: n elements of dtype in_code; codes: nb * 256 int8 (bits 8) or
// nb * 128 uint8 (bits 4); scales: nb f32.  Returns the cudaError_t of
// the launch (0 on success).
int hvd_quantize_blockwise(int device, const void* x, long long n, int in_code,
                           int bits, void* codes, void* scales, void* stream) {
  if (n <= 0) return 0;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scales);
  switch (in_code) {
    case kF32: return (int)launch_quantize<float>(x, n, bits, codes, sc, s);
    case kF16: return (int)launch_quantize<__half>(x, n, bits, codes, sc, s);
    case kBF16: return (int)launch_quantize<__nv_bfloat16>(x, n, bits, codes, sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// codes, scales as above; out: n elements of dtype out_code.
int hvd_dequantize_blockwise(int device, const void* codes, const void* scales,
                             long long n, int bits, int out_code, void* out,
                             void* stream) {
  if (n <= 0) return 0;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  switch (out_code) {
    case kF32: return (int)launch_dequantize<float>(codes, sc, n, bits, out, s);
    case kF16: return (int)launch_dequantize<__half>(codes, sc, n, bits, out, s);
    case kBF16: return (int)launch_dequantize<__nv_bfloat16>(codes, sc, n, bits, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
