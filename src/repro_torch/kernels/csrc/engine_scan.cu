// Per-set cache-engine scan for Hopper (sm_90a): the hand-written CUDA
// counterpart of the Pallas bodies in src/repro/kernels/engine_scan.py.
//
//   conv_scan_kernel  <- _conv_scan_kernel (engine_scan.py:97) and its
//                        stateful twin _conv_state_kernel (:248)
//   ext_scan_kernel   <- _ext_scan_kernel (:135) and _ext_state_kernel (:283)
//
// One warp owns one (trace, set) and replays that set's L packed request
// slots in order.  A null state-in pointer means a cold set, a null
// state-out pointer drops the final rows, so the monolithic and the
// stateful (epoch-carry) scans are one code path.
//
// Bound: each set is a serial chain of dependent steps and a launch holds
// B*S such chains, so the card is limited by the instructions a step
// issues and by how many chains an SM keeps resident to hide a step's
// latency, not by the B*S*L*~11 input bytes.  The design cuts both:
//
//  * The ways live in registers, way = k * 32 + lane (K ways a lane), each
//    as its tag and one packed word.  An extended way's word is
//        absent << 25 | invalid << 24 | lru << 12 | way << 4 | dirty << 3
//        | size / 32
//    whose unsigned order is jnp.argmin's victim order (valid ways by
//    lru, then way), so one __reduce_min_sync of the lanes' minima names
//    the victim together with its dirty bit and size; a conventional
//    way's word is keyed the same way (conv_scan_kernel).  This takes the
//    rows the engine makes: lru <= LRU_MAX, sizes that are multiples of
//    32 below 256, a tag valid in at most one way of a set.
//  * A warp-uniform count of valid ways answers "any way valid" without a
//    vote; a per-lane mask of invalid ways gives the first free way in one
//    reduction, on a miss only.
//  * The Bloom filters live on the lanes: lane l holds word l % 8 of bf1
//    and of bf2.  Each lane writes its slot's Bloom mask (8 words) to
//    shared memory once a chunk, so a request reads its word with one
//    load; one ballot (lanes 0-7 test bf1, lanes 8-15 bf2) answers both
//    membership tests; the insert is an OR, the swap two moves.
//  * The lookup, the first victim and the Bloom tests are independent of
//    one another, issued together and then selected.
//  * The request columns are loaded 32 slots a chunk, one slot a lane,
//    with the next chunk in flight while this one replays.  A chunk's
//    write / mask / level bits become warp-uniform ballots, so a request
//    costs one shuffle (its tag).
//  * Stats are a chunk's bitmasks of the requests' outcomes (hit, forward,
//    swap), counted once a chunk; the float sums are formed from the
//    counts once at the end (the reference sums the same per-request
//    constants, so the two agree within rounding).
//
// Plain C interface (loaded with ctypes): each launcher returns
// cudaGetLastError() and launches on the caller's stream;
// engine_scan_launch_shape reports a launch's blocks and the blocks an SM
// keeps resident.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xffffffffu;
constexpr uint32_t LRU_MAX = 0xFFFu;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int NI = 9;
constexpr int NF = 5;
constexpr int BLOOM_WORDS = 8;
constexpr int BLOOM_BITS = BLOOM_WORDS * 32;
constexpr int BLOCK_BYTES = 128;
constexpr int MAX_EVICTIONS = BLOCK_BYTES / 32;
constexpr int HIGH = 0;
constexpr int LOW = 1;
constexpr int PRED_BLOOM = 0;
constexpr int PRED_PERFECT = 2;

// Fields of the packed way words (see the head of the file).
constexpr uint32_t W_SIZE = 0x7u;
constexpr uint32_t W_DIRTY = 0x8u;
constexpr uint32_t W_WAY = 0xFF0u;
constexpr uint32_t W_LRU = LRU_MAX << 12;
constexpr uint32_t W_LRU_ONE = 1u << 12;
constexpr uint32_t W_INVALID = 1u << 24;
constexpr uint32_t W_ABSENT = 1u << 25;
constexpr uint32_t NO_WAY = 0xFFFFu;

// Stats vector order: engine_scan.INT_FIELDS / FLOAT_FIELDS.
enum { I_CONV_HITS, I_CONV_MISSES, I_EXT_HITS, I_EXT_FP, I_EXT_PM,
       I_EXT_TRUE_MISS, I_DRAM, I_WB, I_SWAPS };
enum { F_LAT, F_ENERGY, F_NOC, F_CONV_BYTES, F_DRAM_BYTES };

struct Costs {
  float lat_ch, lat_cm, lat_eh, lat_em, lat_pm;
  float e_conv, e_ext, e_ext_pm, e_dram;
};

// One lane's slot of a chunk of request columns, as loaded.
struct Slot {
  uint32_t tag;
  int32_t level;
  uint8_t write, active, mask;
};

__device__ __forceinline__ Slot load_slot(
    const uint32_t* tag, const uint8_t* write, const int32_t* level,
    const uint8_t* active, const uint8_t* mask, long base, int t, int L) {
  Slot s = {0u, 0, 0, 0, 0};
  if (t < L) {
    const long o = base + t;
    s.tag = tag[o];
    s.write = write[o];
    s.active = active[o];
    s.mask = mask[o];
    if (level) s.level = level[o];
  }
  return s;
}

// A chunk as the replay reads it: lane j's tag, and the chunk's bits as
// warp-uniform masks (bit j = slot t0 + j).
struct Chunk {
  uint32_t tag, todo, write, mask, high, low;
};

__device__ __forceinline__ Chunk chunk_of(const Slot& s) {
  Chunk c;
  c.tag = s.tag;
  c.todo = __ballot_sync(FULL, s.active != 0);
  c.write = __ballot_sync(FULL, s.write != 0);
  c.mask = __ballot_sync(FULL, s.mask != 0);
  c.high = __ballot_sync(FULL, s.level == HIGH);
  c.low = __ballot_sync(FULL, s.level == LOW);
  return c;
}

__device__ __forceinline__ void write_stats(const int32_t (&ints)[NI],
                                            const float (&flts)[NF],
                                            long set, int32_t* out_i,
                                            float* out_f, int lane) {
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NI; ++q) out_i[set * NI + q] = ints[q];
#pragma unroll
    for (int q = 0; q < NF; ++q) out_f[set * NF + q] = flts[q];
  }
}

// ------------------------------------------------------- conventional tier

struct ConvArgs {
  const uint32_t* tag;
  const uint8_t* write;
  const uint8_t* active;
  const uint8_t* mask;
  int n_sets, L, W;
  Costs c;
  const uint32_t* tags0;
  const uint8_t* valid0;
  const uint8_t* dirty0;
  const uint32_t* lru0;
  int32_t* ints;
  float* flts;
  uint32_t* tags1;
  uint8_t* valid1;
  uint8_t* dirty1;
  uint32_t* lru1;
};

// A conventional way is its tag and one packed word
//     valid << 24 | lru << 12 | lane << 4 | dirty
// and its victim key is that word for a valid way, lane << 4 for an
// invalid one (FULL for an absent lane): the key order is the reference's
// argmin over (valid ? lru : -1), the first invalid way, else the least
// lru, first index, and the victim key's bit 0 says whether the victim is
// a dirty valid block.  The hit vote and the victim reduction are
// independent; the lane to touch or fill is the matching lane on a hit
// (a tag is valid in at most one way of a set) and the lane whose key is
// the victim on a miss.
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
conv_scan_kernel(const ConvArgs a) {
  constexpr uint32_t C_VALID = 1u << 24;
  const int lane = threadIdx.x & 31;
  const long set = static_cast<long>(blockIdx.x) * WARPS_PER_BLOCK +
                   (threadIdx.x >> 5);
  if (set >= a.n_sets) return;  // warp-uniform
  const bool exists = lane < a.W;
  const long row = set * a.W + lane;
  const uint32_t lane_bits = static_cast<uint32_t>(lane) << 4;
  const uint32_t invalid_key = exists ? lane_bits : FULL;

  uint32_t tg = 0u, w = lane_bits;
  bool live = false;  // exists and valid
  if (a.tags0 != nullptr && exists) {
    tg = a.tags0[row];
    live = a.valid0[row] != 0;
    w |= (live ? C_VALID : 0u) | ((a.lru0[row] & LRU_MAX) << 12) |
         (a.dirty0[row] ? 1u : 0u);
  }
  int n_m = 0, n_hit = 0, n_wb = 0;
  const long base = set * a.L;

  Slot next = load_slot(a.tag, a.write, nullptr, a.active, a.mask, base,
                        lane, a.L);
  for (int t0 = 0; t0 < a.L; t0 += 32) {
    const Chunk ch = chunk_of(next);
    if (t0 + 32 < a.L)  // warp-uniform; in flight during this chunk
      next = load_slot(a.tag, a.write, nullptr, a.active, a.mask, base,
                       t0 + 32 + lane, a.L);
    uint32_t todo = ch.todo, hit_bits = 0u, wb_bits = 0u;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const uint32_t bit = 1u << j;
      const uint32_t rt = __shfl_sync(FULL, ch.tag, j);
      const uint32_t key = live ? w : invalid_key;
      const uint32_t vic = __reduce_min_sync(FULL, key);
      const bool match = live && tg == rt;
      const bool hit = __any_sync(FULL, match);
      const bool sel = hit ? match : key == vic;
      const uint32_t wr = (ch.write & bit) ? 1u : 0u;
      const uint32_t filled = hit ? w | W_LRU | wr
                                  : C_VALID | W_LRU | lane_bits | wr;
      const uint32_t aged = (w & W_LRU) ? w - W_LRU_ONE : w;
      w = sel ? filled : aged;
      tg = sel ? rt : tg;
      live = live || sel;
      hit_bits |= hit ? bit : 0u;
      wb_bits |= (!hit && (vic & 1u)) ? bit : 0u;
    }
    n_m += __popc(ch.mask & ch.todo);
    n_hit += __popc(ch.mask & hit_bits);
    n_wb += __popc(ch.mask & wb_bits);
  }

  // request_stats, conventional side, summed over the set's requests
  const Costs c = a.c;
  const int n_miss = n_m - n_hit;
  int32_t ints[NI] = {};
  ints[I_CONV_HITS] = n_hit;
  ints[I_CONV_MISSES] = n_miss;
  ints[I_DRAM] = n_miss;
  ints[I_WB] = n_wb;
  float flts[NF] = {};
  flts[F_LAT] = n_hit * c.lat_ch + n_miss * c.lat_cm;
  flts[F_ENERGY] = n_m * c.e_conv + (n_miss + n_wb) * c.e_dram;
  flts[F_CONV_BYTES] = static_cast<float>(n_m * BLOCK_BYTES);
  flts[F_DRAM_BYTES] = static_cast<float>((n_miss + n_wb) * BLOCK_BYTES);
  write_stats(ints, flts, set, a.ints, a.flts, lane);
  if (a.tags1 != nullptr && exists) {
    a.tags1[row] = tg;
    a.valid1[row] = live;
    a.dirty1[row] = w & 1u;
    a.lru1[row] = (w >> 12) & LRU_MAX;
  }
}

// --------------------------------------------------------- extended tier

struct ExtArgs {
  const uint32_t* tag;
  const uint8_t* write;
  const int32_t* level;
  const uint8_t* active;
  const uint8_t* mask;
  int n_sets, L, W, budget, ext_ways, predictor, compression;
  Costs c;
  const uint32_t* tags0;
  const uint8_t* valid0;
  const uint8_t* dirty0;
  const uint32_t* lru0;
  const int32_t* size0;
  const int32_t* used0;
  const uint32_t* bf1_0;
  const uint32_t* bf2_0;
  const int32_t* nmru0;
  int32_t* ints;
  float* flts;
  uint32_t* tags1;
  uint8_t* valid1;
  uint8_t* dirty1;
  uint32_t* lru1;
  int32_t* size1;
  int32_t* used1;
  uint32_t* bf1_1;
  uint32_t* bf2_1;
  int32_t* nmru1;
};

// The Bloom mask of a tag (repro/core/bloom.py: h = tag * m (mod 2^32);
// h ^= h >> 15; bit h % 256 of the filter), written as its 8 words.
__device__ __forceinline__ void bloom_words(uint32_t tag,
                                            uint32_t (&row)[BLOOM_WORDS]) {
  const uint32_t mult[3] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du};
  reinterpret_cast<uint4*>(row)[0] = make_uint4(0u, 0u, 0u, 0u);
  reinterpret_cast<uint4*>(row)[1] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t h = tag * mult[i];
    h ^= h >> 15;
    h %= BLOOM_BITS;
    row[h >> 5] |= 1u << (h & 31u);
  }
}

// The least of the lane's K way words, then of the warp's.
template <int K>
__device__ __forceinline__ uint32_t warp_min_word(const uint32_t (&w)[K]) {
  uint32_t m = w[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, w[k]);
  return __reduce_min_sync(FULL, m);
}

template <int K>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
ext_scan_kernel(const ExtArgs a) {
  const int lane = threadIdx.x & 31;
  const long set = static_cast<long>(blockIdx.x) * WARPS_PER_BLOCK +
                   (threadIdx.x >> 5);
  if (set >= a.n_sets) return;  // warp-uniform
  const bool cold = a.tags0 == nullptr;
  // the Bloom masks of this warp's chunk, one row a slot
  __shared__ __align__(16) uint32_t masks_s[WARPS_PER_BLOCK][32][BLOOM_WORDS];
  uint32_t (&masks)[32][BLOOM_WORDS] = masks_s[threadIdx.x >> 5];

  uint32_t tg[K], w[K];
  uint32_t inv = 0u;  // bit k: way k * 32 + lane exists and is invalid
  int my_valid = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int way = k * 32 + lane;
    const uint32_t wbits = static_cast<uint32_t>(way) << 4;
    tg[k] = 0u;
    if (way >= a.W) {
      w[k] = W_ABSENT | W_INVALID | wbits;
    } else if (cold) {
      w[k] = W_INVALID | wbits;
      inv |= 1u << k;
    } else {
      const long r = set * a.W + way;
      tg[k] = a.tags0[r];
      const bool vd = a.valid0[r] != 0;
      w[k] = (vd ? 0u : W_INVALID) | ((a.lru0[r] & LRU_MAX) << 12) | wbits |
             (a.dirty0[r] ? W_DIRTY : 0u) |
             ((static_cast<uint32_t>(a.size0[r]) >> 5) & W_SIZE);
      inv |= vd ? 0u : 1u << k;
      my_valid += vd;
    }
  }
  const uint32_t q = lane & (BLOOM_WORDS - 1);
  uint32_t bf1 = cold ? 0u : a.bf1_0[set * BLOOM_WORDS + q];
  uint32_t bf2 = cold ? 0u : a.bf2_0[set * BLOOM_WORDS + q];
  int used = cold ? 0 : a.used0[set];
  int nmru = cold ? 0 : a.nmru0[set];
  int n_valid = static_cast<int>(__reduce_add_sync(FULL, my_valid));

  const bool bloom = a.predictor == PRED_BLOOM;
  const bool perfect = a.predictor == PRED_PERFECT;
  int n_hit = 0, n_fp = 0, n_pm = 0, n_miss = 0, n_wb = 0, n_swap = 0;
  const long base = set * a.L;

  Slot next = load_slot(a.tag, a.write, a.level, a.active, a.mask, base,
                        lane, a.L);
  for (int t0 = 0; t0 < a.L; t0 += 32) {
    const Chunk ch = chunk_of(next);
    if (bloom) {
      __syncwarp();  // the last chunk's rows are read
      bloom_words(ch.tag, masks[lane]);
      __syncwarp();
    }
    if (t0 + 32 < a.L)  // warp-uniform; in flight during this chunk
      next = load_slot(a.tag, a.write, a.level, a.active, a.mask, base,
                       t0 + 32 + lane, a.L);
    uint32_t todo = ch.todo, hit_bits = 0u, pred_bits = 0u, swap_bits = 0u;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const uint32_t bit = 1u << j;
      const uint32_t rt = __shfl_sync(FULL, ch.tag, j);
      const bool wr = ch.write & bit;
      const uint32_t phys = !a.compression   ? BLOCK_BYTES
                            : (ch.high & bit) ? 32u
                            : (ch.low & bit)  ? 64u
                                              : BLOCK_BYTES;

      // independent of one another: the first victim, the lookup, the
      // Bloom tests
      const uint32_t victim0 = warp_min_word<K>(w);
      uint32_t mine = NO_WAY;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if (tg[k] == rt && w[k] < W_INVALID) mine = k * 32 + lane;
      const uint32_t e_way = __reduce_min_sync(FULL, mine);
      const uint32_t mq = bloom ? masks[j][q] : 0u;
      const uint32_t probe = (lane & BLOOM_WORDS) ? bf2 : bf1;
      const uint32_t tests = __ballot_sync(FULL, (probe & mq) == mq);
      const bool hit = e_way != NO_WAY;
      const bool pred = bloom ? (tests & 0xFFu) == 0xFFu : perfect ? hit
                                                                   : true;

      uint32_t cw = e_way;  // the way touched or filled
      int wbs = 0;
      if (!hit) {  // insert: LRU-evict until the block fits (<= 4 times)
        uint32_t v = victim0;
        for (int it = 0; it < MAX_EVICTIONS; ++it) {
          if (used + static_cast<int>(phys) <= a.budget || n_valid == 0)
            break;
          if (it > 0) v = warp_min_word<K>(w);
          wbs += (v >> 3) & 1u;
          used -= static_cast<int>((v & W_SIZE) << 5);
          --n_valid;
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (w[k] == v) {
              w[k] = (w[k] & (W_LRU | W_WAY)) | W_INVALID;
              inv |= 1u << k;
            }
        }
        // free way: the first invalid way, way 0 when none (jnp.argmax)
        const uint32_t fw = __reduce_min_sync(
            FULL, inv ? static_cast<uint32_t>((__ffs(inv) - 1) * 32 + lane)
                      : NO_WAY);
        n_valid += fw != NO_WAY;
        cw = fw != NO_WAY ? fw : 0u;
        used += static_cast<int>(phys);
      }
      // touch (hit) or fill (miss) way cw; every other way ages
      const uint32_t keep = hit ? FULL : W_WAY;
      const uint32_t set_bits =
          W_LRU | (wr ? W_DIRTY : 0u) | (hit ? 0u : phys >> 5);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (static_cast<uint32_t>(k * 32 + lane) == cw) {
          w[k] = (w[k] & keep) | set_bits;
          tg[k] = rt;
        } else if (w[k] & W_LRU) {
          w[k] -= W_LRU_ONE;
        }
      }
      if (static_cast<uint32_t>(lane) == (cw & 31u)) inv &= ~(1u << (cw >> 5));

      // Bloom maintenance (Fig. 6(b)): insert into both filters, count
      // the tag if it was not in bf2, swap at the associativity
      bool swap = false;
      if (bloom) {
        bf1 |= mq;
        bf2 |= mq;
        nmru += (tests & 0xFF00u) == 0xFF00u ? 0 : 1;
        if (nmru >= a.ext_ways) {
          swap = true;
          bf1 = bf2;
          bf2 = 0u;
          nmru = 0;
        }
      }

      hit_bits |= hit ? bit : 0u;
      pred_bits |= pred ? bit : 0u;
      swap_bits |= swap ? bit : 0u;
      n_wb += (ch.mask & bit) ? wbs : 0;  // 0 on a hit
    }
    // request_stats, extended side, of the chunk's counted requests
    const uint32_t m = ch.mask;
    n_hit += __popc(m & hit_bits);
    n_fp += __popc(m & ~hit_bits & pred_bits);
    n_pm += __popc(m & ~pred_bits);
    n_miss += __popc(m & ~hit_bits);
    n_swap += __popc(m & swap_bits);
  }

  const Costs c = a.c;
  int32_t ints[NI] = {};
  ints[I_EXT_HITS] = n_hit;
  ints[I_EXT_FP] = n_fp;
  ints[I_EXT_PM] = n_pm;
  ints[I_EXT_TRUE_MISS] = n_miss;
  ints[I_DRAM] = n_miss;
  ints[I_WB] = n_wb;
  ints[I_SWAPS] = n_swap;
  float flts[NF] = {};
  flts[F_LAT] = n_hit * c.lat_eh + n_fp * c.lat_em + n_pm * c.lat_pm;
  flts[F_ENERGY] = (n_hit + n_fp) * c.e_ext + n_pm * c.e_ext_pm +
                   (n_miss + n_wb) * c.e_dram;
  flts[F_NOC] = static_cast<float>((n_hit + n_fp + n_miss + n_wb) *
                                   BLOCK_BYTES);
  flts[F_DRAM_BYTES] = static_cast<float>((n_miss + n_wb) * BLOCK_BYTES);
  write_stats(ints, flts, set, a.ints, a.flts, lane);
  if (a.tags1 != nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int way = k * 32 + lane;
      if (way < a.W) {
        const long r = set * a.W + way;
        a.tags1[r] = tg[k];
        a.valid1[r] = (w[k] & W_INVALID) == 0u;
        a.dirty1[r] = (w[k] & W_DIRTY) != 0u;
        a.lru1[r] = (w[k] & W_LRU) >> 12;
        a.size1[r] = static_cast<int32_t>((w[k] & W_SIZE) << 5);
      }
    }
    if (lane < BLOOM_WORDS) {
      a.bf1_1[set * BLOOM_WORDS + lane] = bf1;
      a.bf2_1[set * BLOOM_WORDS + lane] = bf2;
    }
    if (lane == 0) {
      a.used1[set] = used;
      a.nmru1[set] = nmru;
    }
  }
}

Costs costs_from(const float* c) {
  return Costs{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
}

unsigned blocks_for(int n_sets) {
  return static_cast<unsigned>((n_sets + WARPS_PER_BLOCK - 1) /
                               WARPS_PER_BLOCK);
}

// The ext_scan_kernel instantiation for W extended ways.
using ExtKernel = void (*)(const ExtArgs);
ExtKernel ext_kernel_for(int W) {
  return W <= 32 ? ext_scan_kernel<1> : W <= 64 ? ext_scan_kernel<2>
         : W <= 128 ? ext_scan_kernel<4> : ext_scan_kernel<8>;
}

}  // namespace

extern "C" {

int conv_scan_launch(const void* tag, const void* write, const void* active,
                     const void* mask, int n_sets, int L, int W,
                     const float* costs, const void* tags0,
                     const void* valid0, const void* dirty0, const void* lru0,
                     void* ints, void* flts, void* tags1, void* valid1,
                     void* dirty1, void* lru1, void* stream) {
  if (n_sets <= 0 || L <= 0 || W <= 0 || W > 32) return cudaErrorInvalidValue;
  ConvArgs a;
  a.tag = static_cast<const uint32_t*>(tag);
  a.write = static_cast<const uint8_t*>(write);
  a.active = static_cast<const uint8_t*>(active);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_sets = n_sets;
  a.L = L;
  a.W = W;
  a.c = costs_from(costs);
  a.tags0 = static_cast<const uint32_t*>(tags0);
  a.valid0 = static_cast<const uint8_t*>(valid0);
  a.dirty0 = static_cast<const uint8_t*>(dirty0);
  a.lru0 = static_cast<const uint32_t*>(lru0);
  a.ints = static_cast<int32_t*>(ints);
  a.flts = static_cast<float*>(flts);
  a.tags1 = static_cast<uint32_t*>(tags1);
  a.valid1 = static_cast<uint8_t*>(valid1);
  a.dirty1 = static_cast<uint8_t*>(dirty1);
  a.lru1 = static_cast<uint32_t*>(lru1);
  conv_scan_kernel<<<blocks_for(n_sets), WARPS_PER_BLOCK * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int ext_scan_launch(const void* tag, const void* write, const void* level,
                    const void* active, const void* mask, int n_sets, int L,
                    int W, int budget, int ext_ways, int predictor,
                    int compression, const float* costs, const void* tags0,
                    const void* valid0, const void* dirty0, const void* lru0,
                    const void* size0, const void* used0, const void* bf1_0,
                    const void* bf2_0, const void* nmru0, void* ints,
                    void* flts, void* tags1, void* valid1, void* dirty1,
                    void* lru1, void* size1, void* used1, void* bf1_1,
                    void* bf2_1, void* nmru1, void* stream) {
  if (n_sets <= 0 || L <= 0 || W <= 0 || W > 256) return cudaErrorInvalidValue;
  ExtArgs a;
  a.tag = static_cast<const uint32_t*>(tag);
  a.write = static_cast<const uint8_t*>(write);
  a.level = static_cast<const int32_t*>(level);
  a.active = static_cast<const uint8_t*>(active);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_sets = n_sets;
  a.L = L;
  a.W = W;
  a.budget = budget;
  a.ext_ways = ext_ways;
  a.predictor = predictor;
  a.compression = compression;
  a.c = costs_from(costs);
  a.tags0 = static_cast<const uint32_t*>(tags0);
  a.valid0 = static_cast<const uint8_t*>(valid0);
  a.dirty0 = static_cast<const uint8_t*>(dirty0);
  a.lru0 = static_cast<const uint32_t*>(lru0);
  a.size0 = static_cast<const int32_t*>(size0);
  a.used0 = static_cast<const int32_t*>(used0);
  a.bf1_0 = static_cast<const uint32_t*>(bf1_0);
  a.bf2_0 = static_cast<const uint32_t*>(bf2_0);
  a.nmru0 = static_cast<const int32_t*>(nmru0);
  a.ints = static_cast<int32_t*>(ints);
  a.flts = static_cast<float*>(flts);
  a.tags1 = static_cast<uint32_t*>(tags1);
  a.valid1 = static_cast<uint8_t*>(valid1);
  a.dirty1 = static_cast<uint8_t*>(dirty1);
  a.lru1 = static_cast<uint32_t*>(lru1);
  a.size1 = static_cast<int32_t*>(size1);
  a.used1 = static_cast<int32_t*>(used1);
  a.bf1_1 = static_cast<uint32_t*>(bf1_1);
  a.bf2_1 = static_cast<uint32_t*>(bf2_1);
  a.nmru1 = static_cast<int32_t*>(nmru1);
  ext_kernel_for(W)<<<blocks_for(n_sets), WARPS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A launch of `tier` (0 conventional, 1 extended) over n_sets sets of W
// ways: its blocks, threads a block, and the blocks an SM keeps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int engine_scan_launch_shape(int tier, int W, int n_sets, int* blocks,
                             int* threads, int* blocks_per_sm) {
  if (n_sets <= 0 || W <= 0 || W > (tier == 0 ? 32 : 256))
    return cudaErrorInvalidValue;
  *blocks = static_cast<int>(blocks_for(n_sets));
  *threads = WARPS_PER_BLOCK * 32;
  const void* kernel =
      tier == 0 ? reinterpret_cast<const void*>(conv_scan_kernel)
                : reinterpret_cast<const void*>(ext_kernel_for(W));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, 0));
}

}  // extern "C"
