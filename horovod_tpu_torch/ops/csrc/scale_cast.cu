// Batched scale + cast between tensors and a device fusion buffer.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::fused_scale_cast (the
// Pallas kernel `_scale_cast_kernel`), and with it the two CUDA kernels
// of the reference Horovod that it stood in for
// (horovod/common/ops/cuda/cuda_kernels.cu: BatchedD2DMemcpy and
// ScaleBuffer).  One launch covers up to kMaxEntries member tensors of a
// fusion bucket: for each entry {src, dst, n} of its table,
//
//     dst[i] = Out(Comp(src[i]) * factor)        for i < n
//
// with Comp = float for f32/f16/bf16 and Comp = double for f64.  The
// multiply is a single round-to-nearest product and the narrowing
// conversions are the round-to-nearest-even intrinsics, so the result
// equals `(src.to(float32) * float32(factor)).to(out_dtype)` bit for bit.
//
// Bound: device-memory bandwidth.  It does one multiply per element and
// moves sizeof(In) + sizeof(Out) bytes, far below the card's
// operations-per-byte balance point, so the design only tries to keep
// memory busy from the first cycle to the last, on a ragged list as on
// one flat tensor:
//   * the table travels by value, as a __grid_constant__ kernel parameter
//     (CUDA 12.1 allows 32,764 bytes of them; kMaxEntries entries of 32 B
//     and the hints take 9.2 KB, and a longer list is split into several
//     launches of the same kernel).  No host-to-device copy is queued
//     ahead of the kernel, and no pinned buffer is allocated per call;
//   * the work list is the entries' tiles laid end to end (tile_end is
//     each entry's running tile count, from the host), one tile per CTA.
//     A CTA finds its entry from a hint the host lays out beside the table
//     (the entry of every hint_stride-th tile, at most kHints of them)
//     and a block-uniform forward scan of a step or two, all in the
//     constant bank: no search through device memory before the loads;
//   * a tile is one 16-byte input vector per thread, neighbouring threads
//     on neighbouring addresses, over many small CTAs, so the block
//     scheduler keeps every SM streaming to the end (a persistent grid
//     walking the tiles, and tiles of 2-4 vectors a thread, measured
//     slower on the H100); an entry's last tile keeps the vector accesses
//     up to its last whole vector and masks only the remainder;
//   * an entry whose pointers are not aligned for the vector width takes
//     element accesses, still coalesced (ragged bucket offsets do this).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;     // threads of a tile, one 16-byte input vector each
constexpr int kMaxEntries = 256;  // entries one launch takes
constexpr int kHints = 1024;      // entry hints of a table

struct Table {
  const void* src[kMaxEntries];
  void* dst[kMaxEntries];
  long long n[kMaxEntries];         // elements
  long long tile_end[kMaxEntries];  // tiles of entries 0..i in the flat work list
  int n_entries;
  int hint_stride;                  // tiles between hints
  uint8_t hint[kHints];             // hint[j]: the entry of tile j * hint_stride
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

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

__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename In, typename Out, typename Comp>
struct Scale {
  __device__ static Out apply(In x, Comp f) {
    return Cvt<Out>::store(mul_rn(Cvt<In>::load(x), f));
  }
};
template <>
struct Scale<double, double, double> {
  __device__ static double apply(double x, double f) { return mul_rn(x, f); }
};

template <typename In, typename Out, typename Comp>
__global__ void __launch_bounds__(kThreads)
scale_cast_batched(const __grid_constant__ Table table, Comp factor) {
  constexpr int V = 16 / sizeof(In);
  constexpr long long kTile = (long long)kThreads * V;
  using S = Scale<In, Out, Comp>;
  const int tile = blockIdx.x;
  int e = table.hint[tile / table.hint_stride];
  while (table.tile_end[e] <= tile) ++e;  // no entry is empty
  const long long first = e > 0 ? table.tile_end[e - 1] : 0;
  const In* __restrict__ src = static_cast<const In*>(table.src[e]);
  Out* __restrict__ dst = static_cast<Out*>(table.dst[e]);
  const long long n = table.n[e];
  const long long base = (tile - first) * kTile;
  const bool vec = (reinterpret_cast<uintptr_t>(src) % (V * sizeof(In)) == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % (V * sizeof(Out)) == 0);
  if (vec) {
    const long long i = base + (long long)threadIdx.x * V;
    if (i + V <= n) {
      const Vec<In, V> in = *reinterpret_cast<const Vec<In, V>*>(src + i);
      Vec<Out, V> out;
#pragma unroll
      for (int j = 0; j < V; ++j) out.v[j] = S::apply(in.v[j], factor);
      *reinterpret_cast<Vec<Out, V>*>(dst + i) = out;
    } else {
      // past the entry's last whole vector: the masked remainder
      for (long long k = i; k < n; ++k) dst[k] = S::apply(src[k], factor);
    }
  } else {
    // unaligned entry: element accesses, neighbouring threads on
    // neighbouring elements
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      if (i < n) dst[i] = S::apply(src[i], factor);
    }
  }
}

// rows: n_entries records {src, dst, n, tile_end} of 4 int64s
template <typename In, typename Out, typename Comp>
cudaError_t launch(const long long* rows, int n_entries, double factor, cudaStream_t stream) {
  Table t;
  for (int i = 0; i < n_entries; ++i) {
    t.src[i] = reinterpret_cast<const void*>(rows[4 * i]);
    t.dst[i] = reinterpret_cast<void*>(rows[4 * i + 1]);
    t.n[i] = rows[4 * i + 2];
    t.tile_end[i] = rows[4 * i + 3];
  }
  t.n_entries = n_entries;
  const long long n_tiles = t.tile_end[n_entries - 1];
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  t.hint_stride = (int)((n_tiles + kHints - 1) / kHints);
  for (int j = 0, e = 0; j < kHints; ++j) {
    while (e < n_entries - 1 && t.tile_end[e] <= (long long)j * t.hint_stride) ++e;
    t.hint[j] = (uint8_t)e;
  }
  scale_cast_batched<In, Out, Comp><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      t, static_cast<Comp>(factor));
  return cudaGetLastError();
}

// dtype codes shared with ops/cuda_kernels.py
enum { kF32 = 0, kF16 = 1, kBF16 = 2, kF64 = 3 };

template <typename In>
cudaError_t dispatch_out(int out_code, const long long* rows, int n_entries, double factor,
                         cudaStream_t s) {
  switch (out_code) {
    case kF32: return launch<In, float, float>(rows, n_entries, factor, s);
    case kF16: return launch<In, __half, float>(rows, n_entries, factor, s);
    case kBF16: return launch<In, __nv_bfloat16, float>(rows, n_entries, factor, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements one tile covers for an input of `in_itemsize` bytes; the host
// lays out tile_end with the same number.
long long hvd_scale_cast_tile_elems(int in_itemsize) {
  return (long long)kThreads * (16 / in_itemsize);
}

// Entries one launch takes.
int hvd_scale_cast_max_entries() { return kMaxEntries; }

// rows: host array of n_entries (1..kMaxEntries) records {src, dst, n,
// tile_end} of 4 int64s, none with n = 0, tile_end increasing; copied into
// the launch's parameters.  Returns the cudaError_t of the launch.
int hvd_scale_cast_batched(int device, const long long* rows, int n_entries, int in_code,
                           int out_code, double factor, void* stream) {
  if (n_entries <= 0) return 0;
  if (n_entries > kMaxEntries) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kF32: err = dispatch_out<float>(out_code, rows, n_entries, factor, s); break;
    case kF16: err = dispatch_out<__half>(out_code, rows, n_entries, factor, s); break;
    case kBF16: err = dispatch_out<__nv_bfloat16>(out_code, rows, n_entries, factor, s); break;
    case kF64:
      err = out_code == kF64 ? launch<double, double, double>(rows, n_entries, factor, s)
                             : cudaErrorInvalidValue;
      break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
