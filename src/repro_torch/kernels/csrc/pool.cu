// The serving page pool's mechanism kernels for Hopper (sm_90a): the
// hand-written CUDA counterparts of four Pallas files of src/repro/kernels/.
//
//   lookup_fill_kernel  <- _tag_lookup_kernel (tag_lookup.py:26): one round
//                          of Algorithm 1, or the pool's conventional tier
//                          (serving/paged_kv.py:221-253 with _conv_fill
//                          :353-365): a batch's rounds and fills in one
//                          launch
//   bloom_query_kernel  <- _query_kernel (bloom_query.py:33): the predictor
//                          query
//   bloom_record_kernel <- _query_kernel's other use, the pool's per-key
//                          _bloom_record (serving/paged_kv.py:390): a
//                          batch's records in one launch
//   page_write_kernel   <- _compress_kernel (bdi.py:28), alone or with the
//                          pool's write_page (serving/paged_kv.py:293 with
//                          _probe :339: the probe, the compression and the
//                          store write in one launch)
//   block_read_kernel   <- _gather_kernel (gather_blocks.py:26) and
//                          _decompress_kernel (bdi.py:45), alone or fused
//                          (ops.cached_block_read: gather, then decompress
//                          on read, in one pass), and both tiers of the
//                          pool's read_pages in one launch
//
// lookup_fill is the paper's helper-kernel idiom (Algorithm 1): the ways
// of a set sit on the lanes of a warp, 4 a lane, the hit is a ballot and
// the first matching way __ffs of it.  Sets narrower than a warp share
// one: a set of G = ceil(W / 4) groups of ways takes a segment of
// next_pow2(G) lanes; sets above 128 ways take the whole warp twice.  The
// reference runs up to 4 rounds a batch, each a tag_lookup over the whole
// store (tag 0 for every set it does not ask about), then fills each miss
// from the host.  Here the host orders the batch's requests by set and
// copies that plan once; each segment loads its set's row into registers,
// replays the rounds and fills on it (the victim is one segment-wide
// minimum of packed (counter, way) words), writes back what changed and
// records each request: one launch and one read-back a batch.
//
// page_write maps one 128-byte page onto one warp: it probes the page's
// set for its tag (ballot + __ffs) and, on a hit, writes the page into the
// store's (set, way) row; BDI compression (lane = 4-byte segment) takes
// the base from lane 0 by __shfl_sync and the int8/int16 fit tests as
// __all_sync votes, and writes level and base beside the payload.
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

// ---------------------------------------------------- lookup and fill

// The arguments of lookup_fill_kernel.  Plan mode (plan given): every set
// replays `rounds` rounds of the batch in place on tags/valid/lru (lru_out
// == lru) and writes one record a request; one-round mode (plan null):
// each set looks up req[s] once, writes hit_out/way_out and the new LRU
// row into lru_out, and fills nothing.
struct LookupArgs {
  uint32_t* tags;
  uint8_t* valid;
  const uint32_t* lru;
  uint32_t* lru_out;
  long long n_sets;
  int W;
  int seg_log2;
  const int32_t* plan;  // offsets (n_sets + 1), tags (n_req), slots (n_req)
  int n_req;
  int rounds;
  int32_t* rec;         // (REC_ROWS, n_req): round, hit, way, evicted, tag
  const uint32_t* req;  // (n_sets,)
  int32_t* hit_out;
  int32_t* way_out;
};

constexpr int REC_ROWS = 5;

// A lane holds 4 ways of a set (way = 4 * (c * seg + sub) + v): with VEC
// (W % 4 == 0, aligned rows) one uint4 of tags, one of LRU counters and
// one word of valid bytes.  A set of G = ceil(W / 4) such groups takes a
// segment of seg = next_pow2(min(G, 32)) lanes and C chunks of it.
template <bool VEC, int C>
__global__ void lookup_fill_kernel(LookupArgs a) {
  const int seg = 1 << a.seg_log2;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long s = (warp << (5 - a.seg_log2)) + (lane >> a.seg_log2);
  const int sub = lane & (seg - 1);
  const int first_lane = lane & ~(seg - 1);
  const uint32_t seg_mask = seg == 32 ? FULL : ((1u << seg) - 1u);
  const bool in_set = s < a.n_sets;
  const int W = a.W;
  const long long row = in_set ? s * W : 0;

  // the set's row, once, into registers; bit 4 * c + v of `here` marks a
  // way that exists, of `vbits` a valid one
  uint32_t t[C][4], l[C][4];
  uint32_t here = 0u, vbits = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w0 = (c * seg + sub) << 2;
    if (VEC && in_set && w0 < W) {
      const uint4 tv = *reinterpret_cast<const uint4*>(a.tags + row + w0);
      const uint4 lv = *reinterpret_cast<const uint4*>(a.lru + row + w0);
      const uint32_t vv =
          *reinterpret_cast<const uint32_t*>(a.valid + row + w0);
      t[c][0] = tv.x; t[c][1] = tv.y; t[c][2] = tv.z; t[c][3] = tv.w;
      l[c][0] = lv.x; l[c][1] = lv.y; l[c][2] = lv.z; l[c][3] = lv.w;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if ((vv >> (8 * v)) & 0xFFu) vbits |= 1u << (4 * c + v);
      here |= 0xFu << (4 * c);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int w = w0 + v;
        const bool ok = !VEC && in_set && w < W;
        t[c][v] = ok ? a.tags[row + w] : 0u;
        l[c][v] = ok ? a.lru[row + w] : 0u;
        if (ok && a.valid[row + w]) vbits |= 1u << (4 * c + v);
        if (ok) here |= 1u << (4 * c + v);
      }
    }
  }

  int lo = 0, hi = 0;
  const int32_t* ptags = nullptr;
  const int32_t* slots = nullptr;
  if (a.plan) {
    if (in_set) {
      lo = a.plan[s];
      hi = a.plan[s + 1];
    }
    ptags = a.plan + a.n_sets + 1;
    slots = ptags + a.n_req;
  }
  const long long K = a.n_req;
  uint32_t dirty = 0u, filled = 0u;  // ways whose LRU / tag changed
  const int rounds = a.plan ? a.rounds : 1;
  for (int r = 0; r < rounds; ++r) {  // warp-uniform
    // the set's r-th request, or tag 0 (as the reference's round does for
    // every set it does not ask about)
    const bool real = lo + r < hi;
    const uint32_t q = a.plan ? (real ? static_cast<uint32_t>(ptags[lo + r])
                                      : 0u)
                              : (in_set ? a.req[s] : 0u);
    // Alg. 1 lines 2-3: the first valid way holding q; the segment's
    // ballot names the first lane with a match, its 4-bit mask the way
    int first = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint32_t m = 0u;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (((vbits >> (4 * c + v)) & 1u) && t[c][v] == q) m |= 1u << v;
      const uint32_t b = (__ballot_sync(FULL, m != 0u) >> first_lane) &
                         seg_mask;
      const int fl = b ? __ffs(b) - 1 : 0;
      const uint32_t mm = __shfl_sync(FULL, m, first_lane + fl);
      if (first < 0 && b != 0u) first = ((c * seg + fl) << 2) + __ffs(mm) - 1;
    }
    const bool hit = first >= 0;
    // Alg. 1 lines 8-12: the hit way to LRU_MAX, the others a saturating
    // decrement; a miss keeps its counters
    if (hit) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int w = ((c * seg + sub) << 2) + v;
          const uint32_t bit = 1u << (4 * c + v);
          const uint32_t old = l[c][v];
          const uint32_t nl = w == first ? LRU_MAX : (old > 0u ? old - 1u : 0u);
          if ((here & bit) && nl != old) {
            l[c][v] = nl;
            dirty |= bit;
          }
        }
    }
    // a real request that missed fills the LRU victim: the least counter,
    // invalid ways (as -1) first, the lowest way on ties -- the least of
    // the packed (counter + 1 or 0, way) words over the segment
    const bool fill = real && !hit;
    int way = hit ? first : 0;
    bool evicted = false;
    uint32_t victim_tag = 0u;
    if (__any_sync(FULL, fill)) {  // warp-uniform
      unsigned long long key = ~0ull;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint32_t bit = 1u << (4 * c + v);
          const unsigned long long k =
              ((vbits & bit) ? (static_cast<unsigned long long>(l[c][v]) + 1ull)
                             : 0ull) << 16 |
              static_cast<unsigned long long>(((c * seg + sub) << 2) + v);
          if ((here & bit) && k < key) key = k;
        }
      for (int o = seg >> 1; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(FULL, key, o);
        key = other < key ? other : key;
      }
      const int vw = static_cast<int>(key & 0xFFFFull);
      uint32_t mine = 0u;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (((c * seg + sub) << 2) + v == vw) mine = t[c][v];
      const int owner = first_lane + ((vw >> 2) & (seg - 1));
      victim_tag = __shfl_sync(FULL, mine, owner);
      if (fill) {
        way = vw;
        evicted = (key >> 16) != 0ull;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (((c * seg + sub) << 2) + v == vw) {
              const uint32_t bit = 1u << (4 * c + v);
              t[c][v] = q;
              l[c][v] = LRU_MAX;
              vbits |= bit;
              dirty |= bit;
              filled |= bit;
            }
      }
    }
    if (real && sub == 0) {
      const long long k = slots[lo + r];
      a.rec[k] = r;
      a.rec[K + k] = hit ? 1 : 0;
      a.rec[2 * K + k] = way;
      a.rec[3 * K + k] = evicted ? 1 : 0;
      a.rec[4 * K + k] = fill ? static_cast<int32_t>(victim_tag) : 0;
    }
    if (!a.plan && in_set && sub == 0) {
      a.hit_out[s] = hit ? 1 : 0;
      a.way_out[s] = way;  // argmax of an all-false row is 0
    }
  }
  if (!in_set) return;
  // requests past the rounds are not run
  if (a.plan)
    for (int k = lo + a.rounds + sub; k < hi; k += seg) {
      const long long i = slots[k];
      a.rec[i] = -1;
      a.rec[K + i] = a.rec[2 * K + i] = a.rec[3 * K + i] = 0;
      a.rec[4 * K + i] = 0;
    }
  // the row back, once: in place only the ways that changed, a new LRU
  // array whole
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w0 = (c * seg + sub) << 2;
    const uint32_t cm = 0xFu << (4 * c);
    if (w0 >= W) continue;
    const bool all = !a.plan;
    if (VEC) {
      if (all || (dirty & cm))
        *reinterpret_cast<uint4*>(a.lru_out + row + w0) =
            make_uint4(l[c][0], l[c][1], l[c][2], l[c][3]);
      if (filled & cm) {
        *reinterpret_cast<uint4*>(a.tags + row + w0) =
            make_uint4(t[c][0], t[c][1], t[c][2], t[c][3]);
        uint32_t vv = 0u;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if ((vbits >> (4 * c + v)) & 1u) vv |= 1u << (8 * v);
        *reinterpret_cast<uint32_t*>(a.valid + row + w0) = vv;
      }
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t bit = 1u << (4 * c + v);
        if (!(here & bit)) continue;
        if (all || (dirty & bit)) a.lru_out[row + w0 + v] = l[c][v];
        if (filled & bit) {
          a.tags[row + w0 + v] = t[c][v];
          a.valid[row + w0 + v] = 1;
        }
      }
    }
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

// ------------------------------------------------------------ page write

// The store a page is written into: with tags, the (n_sets, W) tags and
// valid bits the page's set is probed in and the (n_sets, W, words) data;
// without, data row p takes page p.  level/base (n_sets, W), or one a row
// without tags, given: the page is BDI-compressed (words == 32).
struct PageStore {
  const uint32_t* tags;
  const uint8_t* valid;
  long long n_sets;
  int W;
  uint32_t* data;
  int32_t* level;
  uint32_t* base;
  int words;
};

// One warp a page.  keys holds the pages' sets (n_pages) then their tags
// (n_pages); a page whose tag no valid way of its set holds is not written.
__global__ void page_write_kernel(PageStore st,
                                  const int32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ pages,
                                  long long n_pages) {
  const long long p =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_pages) return;  // warp-uniform
  long long row = p;
  if (st.tags) {
    // the probe: the first valid way holding the tag (ballot + __ffs)
    const long long s = keys[p];
    const uint32_t tag = static_cast<uint32_t>(keys[n_pages + p]);
    if (s < 0 || s >= st.n_sets) return;
    int way = -1;
    for (int c = 0; c < st.W; c += 32) {  // warp-uniform trip count
      const int w = c + lane;
      const bool m = w < st.W && st.valid[s * st.W + w] != 0 &&
                     st.tags[s * st.W + w] == tag;
      const uint32_t b = __ballot_sync(FULL, m);
      if (b != 0u) {
        way = c + __ffs(b) - 1;
        break;
      }
    }
    if (way < 0) return;  // a miss writes nothing
    row = s * st.W + way;
  }
  if (st.level) {
    // BDI (lane = segment, words == 32): the base is lane 0's word, the
    // int8/int16 fit tests are votes over the mod-2^32 deltas
    const uint32_t* src = pages + p * 32;
    uint32_t* dst = st.data + row * 32;
    const uint32_t x = src[lane];
    const uint32_t b = __shfl_sync(FULL, x, 0);
    const uint32_t d = x - b;
    const bool fits8 = __all_sync(FULL, d <= 127u || d >= 0xFFFFFF80u);
    const bool fits16 = __all_sync(FULL, d <= 32767u || d >= 0xFFFF8000u);
    const int lvl = fits8 ? HIGH : (fits16 ? LOW : UNCOMP);
    dst[lane] = lvl == UNCOMP ? x : d;
    if (lane == 0) {
      st.level[row] = lvl;
      st.base[row] = b;
    }
  } else {
    const uint32_t* src = pages + p * st.words;
    uint32_t* dst = st.data + row * st.words;
    for (int i = lane; i < st.words; i += 32) dst[i] = src[i];
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

// W <= 256 (the wrapper checks); vec: W % 4 == 0 and the rows aligned
// for uint4 (tags, lru, lru_out) and word (valid) loads.
int lookup_fill_launch(void* tags, void* valid, const void* lru,
                       void* lru_out, long long n_sets, int W,
                       const void* plan, int n_req, int rounds, void* rec,
                       const void* req, void* hit, void* way, int vec,
                       void* stream) {
  const int groups = (W + 3) / 4;
  int seg_log2 = 0;
  while ((1 << seg_log2) < groups && seg_log2 < 5) ++seg_log2;
  const LookupArgs a = {static_cast<uint32_t*>(tags),
                        static_cast<uint8_t*>(valid),
                        static_cast<const uint32_t*>(lru),
                        static_cast<uint32_t*>(lru_out), n_sets, W, seg_log2,
                        static_cast<const int32_t*>(plan), n_req, rounds,
                        static_cast<int32_t*>(rec),
                        static_cast<const uint32_t*>(req),
                        static_cast<int32_t*>(hit),
                        static_cast<int32_t*>(way)};
  const long long sets_per_warp = 32 >> seg_log2;
  const long long warps = (n_sets + sets_per_warp - 1) / sets_per_warp;
  const unsigned grid = blocks_for(warps * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = groups > 32;
  if (vec && wide)
    lookup_fill_kernel<true, 2><<<grid, THREADS, 0, st>>>(a);
  else if (vec)
    lookup_fill_kernel<true, 1><<<grid, THREADS, 0, st>>>(a);
  else if (wide)
    lookup_fill_kernel<false, 2><<<grid, THREADS, 0, st>>>(a);
  else
    lookup_fill_kernel<false, 1><<<grid, THREADS, 0, st>>>(a);
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

// tags null: page p into data row p; level null: a raw copy (any words).
int page_write_launch(const void* tags, const void* valid, long long n_sets,
                      int W, void* data, void* level, void* base, int words,
                      const void* keys, const void* pages, long long n_pages,
                      void* stream) {
  const PageStore st = {static_cast<const uint32_t*>(tags),
                        static_cast<const uint8_t*>(valid), n_sets, W,
                        static_cast<uint32_t*>(data),
                        static_cast<int32_t*>(level),
                        static_cast<uint32_t*>(base), words};
  page_write_kernel<<<blocks_for(n_pages * 32), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(keys),
      static_cast<const uint32_t*>(pages), n_pages);
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
