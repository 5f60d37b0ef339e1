// The serving page pool's mechanism kernels for Hopper (sm_90a): the
// hand-written CUDA counterparts of four Pallas files of src/repro/kernels/.
//
//   tag_lookup_kernel   <- _tag_lookup_kernel (tag_lookup.py:26)
//   bloom_query_kernel  <- _query_kernel (bloom_query.py:33)
//   bdi_compress_kernel <- _compress_kernel (bdi.py:28)
//   block_read_kernel   <- _gather_kernel (gather_blocks.py:26) and
//                          _decompress_kernel (bdi.py:45), alone or fused
//                          (ops.cached_block_read: gather, then decompress
//                          on read, in one pass)
//
// tag_lookup is the paper's helper-kernel idiom (Algorithm 1): the ways of
// a set sit on the lanes of a warp, the hit is a ballot and the first
// matching way is __ffs of it.  Sets narrower than a warp share one: a set
// of W <= 32 ways takes a segment of next_pow2(W) lanes; wider sets take
// the whole warp and loop over 32-way chunks.  BDI maps one 128-byte block
// onto one warp (lane = 4-byte segment): the base is lane 0's word by
// __shfl_sync and the int8/int16 fit tests are __all_sync votes.  The block
// read gives one warp to one output row (lane = word): it reads only the
// selected way's row and, with level/base, restores it on the way out.
// bloom_query gives one thread to one query and reads only the 3 filter
// words its hashes select.
//
// Bound: every kernel moves each byte once and does a few integer
// operations per byte, so each is bound by device-memory bytes; the
// layouts above make each warp's loads and stores contiguous.
//
// All u32 quantities arrive as int32 bit patterns and are read here as
// uint32_t; valid bits are one byte each.  Plain C interface (loaded with
// ctypes): each launcher returns cudaGetLastError() and launches on the
// caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xffffffffu;
constexpr uint32_t LRU_MAX = 0xFFFu;
constexpr int THREADS = 256;
constexpr int WARPS_PER_BLOCK = THREADS / 32;
constexpr int HIGH = 0;
constexpr int LOW = 1;
constexpr int UNCOMP = 2;
constexpr int NUM_HASHES = 3;
__constant__ uint32_t HASH_MULTIPLIERS[NUM_HASHES] = {
    0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du};

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

// ------------------------------------------------------------ tag lookup

// Lanes [seg * k, seg * (k + 1)) of a warp serve one set, seg = 1 << seg_log2.
__global__ void tag_lookup_kernel(const uint32_t* __restrict__ tags,
                                  const uint8_t* __restrict__ valid,
                                  const uint32_t* __restrict__ lru,
                                  const uint32_t* __restrict__ req,
                                  long long n_sets, int W, int seg_log2,
                                  int32_t* __restrict__ hit_out,
                                  int32_t* __restrict__ way_out,
                                  uint32_t* __restrict__ lru_out) {
  const int seg = 1 << seg_log2;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long s = (warp << (5 - seg_log2)) + (lane >> seg_log2);
  const int sub = lane & (seg - 1);
  const int first_lane = lane & ~(seg - 1);
  const uint32_t seg_mask = seg == 32 ? FULL : ((1u << seg) - 1u);
  const bool in_set = s < n_sets;
  const uint32_t r = in_set ? req[s] : 0u;
  const long long row = s * W;

  // Alg. 1 lines 2-3: every lane compares its ways; the first matching
  // way of the set is the lowest set bit of its segment's ballot.
  int first = -1;
  for (int c = 0; c < W; c += seg) {  // warp-uniform trip count
    const int w = c + sub;
    const bool m = in_set && w < W && valid[row + w] != 0 &&
                   tags[row + w] == r;
    const uint32_t b = (__ballot_sync(FULL, m) >> first_lane) & seg_mask;
    if (first < 0 && b != 0u) first = c + __ffs(b) - 1;
  }
  if (!in_set) return;
  const bool hit = first >= 0;
  const int way = hit ? first : 0;  // argmax of an all-false row is 0
  if (sub == 0) {
    hit_out[s] = hit ? 1 : 0;
    way_out[s] = way;
  }
  // Alg. 1 lines 8-12 on hit rows: the hit way to LRU_MAX, the others a
  // saturating decrement; miss rows keep their counters.
  for (int w = sub; w < W; w += seg) {
    const uint32_t l = lru[row + w];
    lru_out[row + w] = !hit ? l : (w == way ? LRU_MAX : (l > 0u ? l - 1u : 0u));
  }
}

// ----------------------------------------------------------- bloom query

__global__ void bloom_query_kernel(const uint32_t* __restrict__ filters,
                                   const uint32_t* __restrict__ tags,
                                   long long n_queries, int words,
                                   int32_t* __restrict__ pred,
                                   uint32_t* __restrict__ masks) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n_queries) return;
  const uint32_t t = tags[q];
  const uint32_t n_bits = static_cast<uint32_t>(words) * 32u;
  const uint32_t* f = filters + q * words;
  uint32_t bits[NUM_HASHES];
  bool present = true;
#pragma unroll
  for (int i = 0; i < NUM_HASHES; ++i) {
    const uint32_t hm = t * HASH_MULTIPLIERS[i];  // mod 2^32
    bits[i] = (hm ^ (hm >> 15)) % n_bits;
    present = present && ((f[bits[i] >> 5] >> (bits[i] & 31u)) & 1u);
  }
  pred[q] = present ? 1 : 0;
  uint32_t* m = masks + q * words;
  for (int w = 0; w < words; ++w) {
    uint32_t v = 0u;
#pragma unroll
    for (int i = 0; i < NUM_HASHES; ++i)
      if (static_cast<int>(bits[i] >> 5) == w) v |= 1u << (bits[i] & 31u);
    m[w] = v;
  }
}

// ---------------------------------------------------------- BDI compress

// One warp per 32-segment block, lane = segment.
__global__ void bdi_compress_kernel(const uint32_t* __restrict__ blocks,
                                    long long n_blocks,
                                    int32_t* __restrict__ level,
                                    uint32_t* __restrict__ base,
                                    uint32_t* __restrict__ payload) {
  const long long blk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= n_blocks) return;  // warp-uniform
  const uint32_t x = blocks[blk * 32 + lane];
  const uint32_t b = __shfl_sync(FULL, x, 0);
  const uint32_t d = x - b;  // mod 2^32
  const bool fits8 = __all_sync(FULL, d <= 127u || d >= 0xFFFFFF80u);
  const bool fits16 = __all_sync(FULL, d <= 32767u || d >= 0xFFFF8000u);
  const int lvl = fits8 ? HIGH : (fits16 ? LOW : UNCOMP);
  payload[blk * 32 + lane] = lvl == UNCOMP ? x : d;
  if (lane == 0) {
    level[blk] = lvl;
    base[blk] = b;
  }
}

// ------------------------------------------------------------ block read

// One warp per output row, lane = word (words > 32 loop).  A null way
// reads way 0; a way outside [0, W) reads zeros, as the reference's
// one-hot select does.  With level (and base), the row is restored:
// base + payload mod 2^32 unless the level is UNCOMP.
__global__ void block_read_kernel(const uint32_t* __restrict__ data,
                                  const int32_t* __restrict__ way,
                                  const int32_t* __restrict__ level,
                                  const uint32_t* __restrict__ base,
                                  long long n_rows, int W, int words,
                                  uint32_t* __restrict__ out) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const int w = way ? way[r] : 0;
  const bool in_range = w >= 0 && w < W;
  const uint32_t* src = data + (r * W + (in_range ? w : 0)) * words;
  const bool restore = level != nullptr && level[r] != UNCOMP;
  const uint32_t b = restore ? base[r] : 0u;
  for (int i = lane; i < words; i += 32) {
    const uint32_t p = in_range ? src[i] : 0u;
    out[r * words + i] = p + b;  // b is 0 unless restoring
  }
}

}  // namespace

extern "C" {

int tag_lookup_launch(const void* tags, const void* valid, const void* lru,
                      const void* req, long long n_sets, int W, int seg_log2,
                      void* hit, void* way, void* lru_out, void* stream) {
  const long long sets_per_warp = 32 >> seg_log2;
  const long long warps = (n_sets + sets_per_warp - 1) / sets_per_warp;
  tag_lookup_kernel<<<blocks_for(warps * 32), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tags), static_cast<const uint8_t*>(valid),
      static_cast<const uint32_t*>(lru), static_cast<const uint32_t*>(req),
      n_sets, W, seg_log2, static_cast<int32_t*>(hit),
      static_cast<int32_t*>(way), static_cast<uint32_t*>(lru_out));
  return static_cast<int>(cudaGetLastError());
}

int bloom_query_launch(const void* filters, const void* tags,
                       long long n_queries, int words, void* pred,
                       void* masks, void* stream) {
  bloom_query_kernel<<<blocks_for(n_queries), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(filters),
      static_cast<const uint32_t*>(tags), n_queries, words,
      static_cast<int32_t*>(pred), static_cast<uint32_t*>(masks));
  return static_cast<int>(cudaGetLastError());
}

int bdi_compress_launch(const void* blocks, long long n_blocks, void* level,
                        void* base, void* payload, void* stream) {
  bdi_compress_kernel<<<blocks_for(n_blocks * 32), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), n_blocks,
      static_cast<int32_t*>(level), static_cast<uint32_t*>(base),
      static_cast<uint32_t*>(payload));
  return static_cast<int>(cudaGetLastError());
}

int block_read_launch(const void* data, const void* way, const void* level,
                      const void* base, long long n_rows, int W, int words,
                      void* out, void* stream) {
  block_read_kernel<<<blocks_for(n_rows * 32), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const int32_t*>(way),
      static_cast<const int32_t*>(level), static_cast<const uint32_t*>(base),
      n_rows, W, words, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
