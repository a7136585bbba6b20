// Batched 64-bit content folds of byte segments: the device side of the
// step-integrity digests (horovod_tpu/core/integrity.py `_fold`).
//
// For each segment {ptr, nbytes} of a table the kernel computes
//
//     w_k    = the little-endian uint64 of bytes [8k, 8k + 8), k < n / 8
//     tail   = the little-endian integer of the last n % 8 bytes (or 0)
//     x      = w_0 ^ w_1 ^ ... ^ tail
//     s      = w_0 + w_1 + ... + tail              (mod 2**64)
//     fold   = x ^ (s * 0x9E3779B97F4A7C15)         (mod 2**64)
//
// which is `_fold` of the same bytes, bit for bit.  Xor and wrapping add
// are exact in any order, so the blocks may reduce in any grouping.
//
// Words are counted from the segment's own first byte, whatever the
// address's alignment (bucket slices of a bf16 row start at 2-byte
// offsets): a thread loads the two aligned 8-byte words that straddle its
// word and funnel-shifts them together.  The aligned words around a
// segment's ends lie in the same 8-byte granule as one of its bytes, so no
// load leaves the allocation's pages.
//
// Work: the segments' tiles (kTileWords words each, at least one tile for
// a segment that has any byte) are laid end to end; one CTA reduces one
// tile to an (xor, sum) partial and finds its segment by a binary search
// of the tile_end column.  A second launch folds each segment's partials
// (one CTA a segment) into its 64-bit result.
//
// The table travels by value, as a __grid_constant__ kernel parameter (as
// scale_cast.cu's does): no host-to-device copy is queued ahead of the
// kernels, so a digest never waits for the stream's earlier work on the
// host.  Three table sizes (16, 256 and 1024 segments) keep a one-payload
// submit's launch small; a longer list is split into several launches.
//
// Bound: device-memory bandwidth; two integer operations per word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTileWords = 8192;   // 64 KiB of input a tile
constexpr uint64_t kSumMix = 0x9E3779B97F4A7C15ull;

template <int N>
struct Table {
  long long ptr[N];       // device address of the segment's first byte
  long long nbytes[N];
  long long tile_end[N];  // tiles of segments 0..i
  int n;
};

__device__ __forceinline__ uint64_t word_at(const uint8_t* p, long long k) {
  uintptr_t a = reinterpret_cast<uintptr_t>(p + 8 * k);
  unsigned shift = static_cast<unsigned>(a & 7u) * 8u;
  const uint64_t* base = reinterpret_cast<const uint64_t*>(a & ~uintptr_t(7));
  uint64_t lo = __ldg(base);
  if (shift == 0) return lo;
  uint64_t hi = __ldg(base + 1);
  return (lo >> shift) | (hi << (64u - shift));
}

__device__ __forceinline__ void block_reduce(uint64_t& x, uint64_t& s) {
  __shared__ uint64_t sx[kThreads / 32], ss[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    x ^= __shfl_xor_sync(0xffffffffu, x, o);
    s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sx[warp] = x;
    ss[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? sx[lane] : 0;
    s = lane < kThreads / 32 ? ss[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      x ^= __shfl_xor_sync(0xffffffffu, x, o);
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
fold_tiles_kernel(const __grid_constant__ Table<N> t,
                  uint64_t* __restrict__ partials) {
  const long long tile = blockIdx.x;
  // the segment whose tile range holds this tile: the first i with
  // tile_end[i] > tile (block-uniform)
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (t.tile_end[mid] > tile) hi = mid; else lo = mid + 1;
  }
  const long long first = lo ? t.tile_end[lo - 1] : 0;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(t.ptr[lo]);
  const long long nbytes = t.nbytes[lo];
  const long long n_words = nbytes / 8;
  long long w0 = (tile - first) * kTileWords;
  long long w1 = w0 + kTileWords < n_words ? w0 + kTileWords : n_words;
  uint64_t x = 0, s = 0;
  for (long long k = w0 + threadIdx.x; k < w1; k += kThreads) {
    uint64_t w = word_at(p, k);
    x ^= w;
    s += w;
  }
  const long long rem = nbytes - 8 * n_words;
  if (tile + 1 == t.tile_end[lo] && rem && threadIdx.x == 0) {
    uint64_t tail = 0;
    for (long long b = 0; b < rem; ++b)
      tail |= static_cast<uint64_t>(p[8 * n_words + b]) << (8 * b);
    x ^= tail;
    s += tail;
  }
  block_reduce(x, s);
  if (threadIdx.x == 0) {
    partials[2 * tile] = x;
    partials[2 * tile + 1] = s;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
fold_segments_kernel(const __grid_constant__ Table<N> t,
                     const uint64_t* __restrict__ partials,
                     uint64_t* __restrict__ out) {
  const int i = blockIdx.x;
  const long long a = i ? t.tile_end[i - 1] : 0;
  const long long b = t.tile_end[i];
  uint64_t x = 0, s = 0;
  for (long long k = a + threadIdx.x; k < b; k += kThreads) {
    x ^= partials[2 * k];
    s += partials[2 * k + 1];
  }
  block_reduce(x, s);
  if (threadIdx.x == 0) out[i] = x ^ (s * kSumMix);
}

template <int N>
int launch(const void* table, long long total_tiles, void* partials,
           void* out, cudaStream_t st) {
  const Table<N>& t = *static_cast<const Table<N>*>(table);
  if (t.n <= 0) return cudaSuccess;
  if (total_tiles > 0) {
    fold_tiles_kernel<N><<<static_cast<unsigned>(total_tiles), kThreads, 0,
                           st>>>(t, static_cast<uint64_t*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fold_segments_kernel<N><<<t.n, kThreads, 0, st>>>(
      t, static_cast<const uint64_t*>(partials), static_cast<uint64_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Words of input one tile covers (digest_kernels.TILE_WORDS must agree).
long long hvd_digest_tile_words() { return kTileWords; }

// The table sizes a launch takes (digest_kernels.TABLE_SIZES must agree).
int hvd_digest_table_size(int k) {
  return k == 0 ? 16 : k == 1 ? 256 : k == 2 ? 1024 : 0;
}

// One 64-bit fold per segment of `table` (host memory laid out as
// Table<cap>: ptr, nbytes and tile_end columns of cap entries each, then
// the segment count); `partials` holds 2 * total_tiles words of device
// scratch and `out` one word a segment.  Returns the cudaError of the
// launches.
int hvd_digest_fold(int device, const void* table, int cap,
                    long long total_tiles, void* partials, void* out,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cap) {
    case 16: return launch<16>(table, total_tiles, partials, out, st);
    case 256: return launch<256>(table, total_tiles, partials, out, st);
    case 1024: return launch<1024>(table, total_tiles, partials, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
