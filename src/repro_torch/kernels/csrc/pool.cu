// The serving page pool's mechanism kernels for Hopper (sm_90a): the
// hand-written CUDA counterparts of four Pallas files of src/repro/kernels/.
//
//   tag_lookup_kernel   <- _tag_lookup_kernel (tag_lookup.py:26)
//   bloom_query_kernel  <- _query_kernel (bloom_query.py:33): the predictor
//                          query
//   bloom_record_kernel <- _query_kernel's other use, the pool's per-key
//                          _bloom_record (serving/paged_kv.py:390): a
//                          batch's records in one launch
//   bdi_compress_kernel <- _compress_kernel (bdi.py:28)
//   block_read_kernel   <- _gather_kernel (gather_blocks.py:26) and
//                          _decompress_kernel (bdi.py:45), alone or fused
//                          (ops.cached_block_read: gather, then decompress
//                          on read, in one pass), and both tiers of the
//                          pool's read_pages in one launch
//
// tag_lookup is the paper's helper-kernel idiom (Algorithm 1): the ways of
// a set sit on the lanes of a warp, the hit is a ballot and the first
// matching way is __ffs of it.  Sets narrower than a warp share one: a set
// of W <= 32 ways takes a segment of next_pow2(W) lanes; wider sets take
// the whole warp and loop over 32-way chunks.  BDI maps one 128-byte block
// onto one warp (lane = 4-byte segment): the base is lane 0's word by
// __shfl_sync and the int8/int16 fit tests are __all_sync votes.
//
// The TPU kernels take their inputs pre-gathered, one tile a set, because
// a BlockSpec brings tiles into VMEM.  On Hopper a warp reads the one row
// it needs by address, so the Bloom query and the block read take the
// pool's whole stores and row indices: nothing is copied around them.
// bloom_query gives one thread to one query and reads only the 3 filter
// words its hashes select, from row rows[q] of the filter store.  The
// block read gives one warp to one output row (lane = word): it reads the
// selected (set, way) row of its tier's store and, on the extended tier,
// restores it with the level and base stored beside it.
//
// bloom_record_kernel replays the reference's per-key record (insert mask,
// the bf2 test, the OR into both filters, the MRU count, the swap) for a
// whole batch.  The host orders the keys by set (stable) and the kernel
// gives one warp to one set's run of keys: both filters sit on the lanes
// (word = chunk * 32 + lane) and stay in registers with the MRU count for
// the whole run, the bf2 test is one __all_sync, the swap a register move,
// and the set's state is written back once.  A run's keys are loaded and
// hashed 32 at a time, one a lane, and broadcast by __shfl_sync, so the
// run's serial chain is the filter update alone.  Sets are independent, so
// warps need no ordering.
//
// Bound: every kernel moves each byte once and does a few integer
// operations per byte, so each is bound by device-memory bytes; the
// layouts above make each warp's loads and stores contiguous.  At the
// serving path's sizes (a few rows a call) a launch costs more than its
// bytes, so the designs cut launches: a batch, not a key, a launch.
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

// The NUM_HASHES bit positions of tag t in a filter of n_bits bits.
__device__ __forceinline__ void hash_bits(uint32_t t, uint32_t n_bits,
                                          uint32_t (&bits)[NUM_HASHES]) {
#pragma unroll
  for (int i = 0; i < NUM_HASHES; ++i) {
    const uint32_t hm = t * HASH_MULTIPLIERS[i];  // mod 2^32
    bits[i] = (hm ^ (hm >> 15)) % n_bits;
  }
}

// The OR-mask of the bits that fall into filter word w.
__device__ __forceinline__ uint32_t word_mask(
    const uint32_t (&bits)[NUM_HASHES], int w) {
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < NUM_HASHES; ++i)
    if (static_cast<int>(bits[i] >> 5) == w) v |= 1u << (bits[i] & 31u);
  return v;
}

// Query q tests filter row rows[q] of the (n_rows, words) store (row q
// when rows is null); a row outside the store reads an empty filter.
__global__ void bloom_query_kernel(const uint32_t* __restrict__ filters,
                                   long long n_rows,
                                   const int32_t* __restrict__ rows,
                                   const uint32_t* __restrict__ tags,
                                   long long n_queries, int words,
                                   int32_t* __restrict__ pred,
                                   uint32_t* __restrict__ masks) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n_queries) return;
  const long long row = rows ? rows[q] : q;
  const bool in_store = row >= 0 && row < n_rows;
  const uint32_t* f = filters + (in_store ? row : 0) * words;
  uint32_t bits[NUM_HASHES];
  hash_bits(tags[q], static_cast<uint32_t>(words) * 32u, bits);
  bool present = in_store;
#pragma unroll
  for (int i = 0; i < NUM_HASHES; ++i)
    present = present && ((f[bits[i] >> 5] >> (bits[i] & 31u)) & 1u);
  pred[q] = present ? 1 : 0;
  uint32_t* m = masks + q * words;
  for (int w = 0; w < words; ++w) m[w] = word_mask(bits, w);
}

// ---------------------------------------------------------- bloom record

// One warp per run of keys that share a set.  plan holds the runs' sets
// (n_runs), their offsets into the ordered tags (n_runs + 1) and the tags;
// lane l holds words c * 32 + l (c < C) of both filters.
template <int C>
__global__ void bloom_record_kernel(uint32_t* __restrict__ bf1,
                                    uint32_t* __restrict__ bf2,
                                    int32_t* __restrict__ n_mru,
                                    const int32_t* __restrict__ plan,
                                    int n_runs, int words, int ways) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_runs) return;  // warp-uniform
  const long long set = plan[r];
  const int lo = plan[n_runs + r];
  const int hi = plan[n_runs + r + 1];
  const uint32_t* tags =
      reinterpret_cast<const uint32_t*>(plan + 2 * n_runs + 1);
  uint32_t* f1 = bf1 + set * words;
  uint32_t* f2 = bf2 + set * words;
  uint32_t a[C], b[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w = c * 32 + lane;
    a[c] = w < words ? f1[w] : 0u;
    b[c] = w < words ? f2[w] : 0u;
  }
  int n = n_mru[set];
  const uint32_t n_bits = static_cast<uint32_t>(words) * 32u;
  // 32 keys at a time: lane j loads and hashes key k0 + j, so the serial
  // chain below holds no global load and no division
  for (int k0 = lo; k0 < hi; k0 += 32) {
    uint32_t mine[NUM_HASHES] = {};
    if (k0 + lane < hi) hash_bits(tags[k0 + lane], n_bits, mine);
    const int keys = min(32, hi - k0);
    for (int j = 0; j < keys; ++j) {  // warp-uniform
      uint32_t bits[NUM_HASHES];
#pragma unroll
      for (int i = 0; i < NUM_HASHES; ++i)
        bits[i] = __shfl_sync(FULL, mine[i], j);
      // the insert mask, tested against bf2 before it is ORed into both
      // filters (the reference ORs bf1's mask into both; the masks are
      // the same: they depend on the tag and the width only)
      bool in_bf2 = true;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t m = word_mask(bits, c * 32 + lane);
        in_bf2 = in_bf2 && (b[c] & m) == m;
        a[c] |= m;
        b[c] |= m;
      }
      if (!__all_sync(FULL, in_bf2)) ++n;
      if (n >= ways) {  // swap (paper Fig. 6 (9))
#pragma unroll
        for (int c = 0; c < C; ++c) {
          a[c] = b[c];
          b[c] = 0u;
        }
        n = 0;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w = c * 32 + lane;
    if (w < words) {
      f1[w] = a[c];
      f2[w] = b[c];
    }
  }
  if (lane == 0) n_mru[set] = n;
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

// The two stores a read may select from: tier 0 reads conv, tier 1 reads
// ext and restores it (base + payload mod 2^32 unless the level is
// UNCOMP) when level is given.  level/base are (sets, ways) beside ext, or
// one a row when level_per_row.
struct ReadStores {
  const uint32_t* conv;
  long long conv_sets;
  int conv_ways;
  const uint32_t* ext;
  long long ext_sets;
  int ext_ways;
  const int32_t* level;
  const uint32_t* base;
  int level_per_row;
};

// One warp per output row r, lane = word (words > 32 loop): tier[r] (or
// fixed_tier when tier is null), set set_idx[r] (r when null) and way
// way[r] (0 when null).  A row of another tier, or whose set or way lies
// outside its store, reads zeros (with per-row levels, the restore still
// adds the row's base, as the reference's one-hot select does).
__global__ void block_read_kernel(ReadStores st,
                                  const int32_t* __restrict__ tier,
                                  int fixed_tier,
                                  const int32_t* __restrict__ set_idx,
                                  const int32_t* __restrict__ way,
                                  long long n_rows, int words,
                                  uint32_t* __restrict__ out) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const int t = tier ? tier[r] : fixed_tier;
  const long long s = set_idx ? set_idx[r] : r;
  const int w = way ? way[r] : 0;
  const bool ext = t == 1;
  const uint32_t* store = ext ? st.ext : st.conv;
  const long long n_sets = ext ? st.ext_sets : st.conv_sets;
  const int n_ways = ext ? st.ext_ways : st.conv_ways;
  const bool set_ok = (t == 0 || ext) && store && s >= 0 && s < n_sets;
  const bool way_ok = set_ok && w >= 0 && w < n_ways;
  const uint32_t* src = store + (way_ok ? s * n_ways + w : 0) * words;
  uint32_t b = 0u;  // 0 unless restoring
  if (ext && st.level && set_ok && (way_ok || st.level_per_row)) {
    const long long li = st.level_per_row ? s : s * n_ways + w;
    if (st.level[li] != UNCOMP) b = st.base[li];
  }
  for (int i = lane; i < words; i += 32)
    out[r * words + i] = (way_ok ? src[i] : 0u) + b;
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

int bloom_query_launch(const void* filters, long long n_rows,
                       const void* rows, const void* tags,
                       long long n_queries, int words, void* pred,
                       void* masks, void* stream) {
  bloom_query_kernel<<<blocks_for(n_queries), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(filters), n_rows,
      static_cast<const int32_t*>(rows), static_cast<const uint32_t*>(tags),
      n_queries, words, static_cast<int32_t*>(pred),
      static_cast<uint32_t*>(masks));
  return static_cast<int>(cudaGetLastError());
}

// words <= 32 * 8 (the wrapper checks); C = the chunks of 32 words a lane
// holds, rounded up to a power of two.
int bloom_record_launch(void* bf1, void* bf2, void* n_mru, const void* plan,
                        int n_runs, int words, int ways, void* stream) {
  const unsigned grid = blocks_for(static_cast<long long>(n_runs) * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<uint32_t*>(bf1);
  auto* b = static_cast<uint32_t*>(bf2);
  auto* n = static_cast<int32_t*>(n_mru);
  const auto* p = static_cast<const int32_t*>(plan);
  if (words <= 32)
    bloom_record_kernel<1><<<grid, THREADS, 0, st>>>(a, b, n, p, n_runs,
                                                     words, ways);
  else if (words <= 64)
    bloom_record_kernel<2><<<grid, THREADS, 0, st>>>(a, b, n, p, n_runs,
                                                     words, ways);
  else if (words <= 128)
    bloom_record_kernel<4><<<grid, THREADS, 0, st>>>(a, b, n, p, n_runs,
                                                     words, ways);
  else
    bloom_record_kernel<8><<<grid, THREADS, 0, st>>>(a, b, n, p, n_runs,
                                                     words, ways);
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

int block_read_launch(const void* conv, long long conv_sets, int conv_ways,
                      const void* ext, long long ext_sets, int ext_ways,
                      const void* level, const void* base, int level_per_row,
                      const void* tier, int fixed_tier, const void* set_idx,
                      const void* way, long long n_rows, int words,
                      void* out, void* stream) {
  const ReadStores st = {static_cast<const uint32_t*>(conv), conv_sets,
                         conv_ways, static_cast<const uint32_t*>(ext),
                         ext_sets, ext_ways,
                         static_cast<const int32_t*>(level),
                         static_cast<const uint32_t*>(base), level_per_row};
  block_read_kernel<<<blocks_for(n_rows * 32), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(tier), fixed_tier,
      static_cast<const int32_t*>(set_idx), static_cast<const int32_t*>(way),
      n_rows, words, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
