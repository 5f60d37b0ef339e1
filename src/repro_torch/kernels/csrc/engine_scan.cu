// Per-set cache-engine scan for Hopper (sm_90a): the hand-written CUDA
// counterpart of the Pallas bodies in src/repro/kernels/engine_scan.py.
//
//   conv_scan_kernel  <- _conv_scan_kernel (engine_scan.py:97) and its
//                        stateful twin _conv_state_kernel (:248)
//   ext_scan_kernel   <- _ext_scan_kernel (:135) and _ext_state_kernel (:283)
//
// One warp owns one (trace, set) and replays that set's L packed request
// slots in order.  The ways live in registers, spread over the lanes (way
// = k * 32 + lane, K ways per lane); the hit way comes from a ballot and
// __ffs, the LRU victim from a warp-wide __reduce_min_sync over
// (key << shift) | way, which reproduces jnp.argmax/argmin's first-index
// rule.  Every lane computes the same warp-uniform outcome and Stats;
// lane 0 writes them.  A null state-in pointer means a cold set, a null
// state-out pointer drops the final rows, so the monolithic and the
// stateful (epoch-carry) scans are one code path.
//
// Bound: each set is a serial chain of L dependent steps (ballot, reduce,
// shuffle latency), so a launch takes about L step latencies whatever its
// B*S*L*~11 input bytes; the design keeps every step in registers, loads
// the request columns 32 slots at a time (one coalesced load per lane,
// then shuffles) and skips padding slots with a ballot.
//
// Plain C interface (loaded with ctypes): each launcher returns
// cudaGetLastError() and launches on the caller's stream.

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
constexpr int PRED_NONE = 1;
constexpr int PRED_PERFECT = 2;

// Stats vector order: engine_scan.INT_FIELDS / FLOAT_FIELDS.
enum { I_CONV_HITS, I_CONV_MISSES, I_EXT_HITS, I_EXT_FP, I_EXT_PM,
       I_EXT_TRUE_MISS, I_DRAM, I_WB, I_SWAPS };
enum { F_LAT, F_ENERGY, F_NOC, F_CONV_BYTES, F_DRAM_BYTES };

struct Costs {
  float lat_ch, lat_cm, lat_eh, lat_em, lat_pm;
  float e_conv, e_ext, e_ext_pm, e_dram;
};

struct Acc {
  int i[NI];
  float f[NF];
};

__device__ __forceinline__ uint32_t sat_dec(uint32_t x) {
  return x > 0u ? x - 1u : 0u;
}

// The request columns of slots [t0, t0 + 32) of one set: lane j holds
// slot t0 + j.  flags = write | active << 1 | mask << 2 | level << 3.
__device__ __forceinline__ void load_chunk(
    const uint32_t* tag, const uint8_t* write, const int32_t* level,
    const uint8_t* active, const uint8_t* mask, long base, int t, int L,
    uint32_t& c_tag, uint32_t& c_flags) {
  c_tag = 0u;
  c_flags = 0u;
  if (t < L) {
    const long o = base + t;
    c_tag = tag[o];
    c_flags = (write[o] ? 1u : 0u) | (active[o] ? 2u : 0u) |
              (mask[o] ? 4u : 0u) |
              (level ? (static_cast<uint32_t>(level[o]) << 3) : 0u);
  }
}

__device__ __forceinline__ void write_stats(const Acc& acc, long set,
                                            int32_t* ints, float* flts,
                                            int lane) {
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NI; ++q) ints[set * NI + q] = acc.i[q];
#pragma unroll
    for (int q = 0; q < NF; ++q) flts[set * NF + q] = acc.f[q];
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

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
conv_scan_kernel(const ConvArgs a) {
  const int lane = threadIdx.x & 31;
  const long set = static_cast<long>(blockIdx.x) * WARPS_PER_BLOCK +
                   (threadIdx.x >> 5);
  if (set >= a.n_sets) return;  // warp-uniform
  const bool exists = lane < a.W;
  const long row = set * a.W + lane;

  uint32_t tg = 0u, lru = 0u;
  bool vd = false, dt = false;
  if (a.tags0 != nullptr && exists) {
    tg = a.tags0[row];
    vd = a.valid0[row] != 0;
    dt = a.dirty0[row] != 0;
    lru = a.lru0[row];
  }
  Acc acc = {};
  const Costs c = a.c;
  const long base = set * a.L;

  for (int t0 = 0; t0 < a.L; t0 += 32) {
    uint32_t c_tag, c_flags;
    load_chunk(a.tag, a.write, nullptr, a.active, a.mask, base, t0 + lane,
               a.L, c_tag, c_flags);
    uint32_t todo = __ballot_sync(FULL, (c_flags & 2u) != 0u);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const uint32_t rt = __shfl_sync(FULL, c_tag, j);
      const uint32_t rf = __shfl_sync(FULL, c_flags, j);
      const bool wr = rf & 1u;
      const bool m = (rf >> 2) & 1u;

      const uint32_t hits = __ballot_sync(FULL, exists && vd && tg == rt);
      const bool hit = hits != 0u;
      int way;
      bool evict_wb = false;
      if (hit) {
        way = __ffs(hits) - 1;
      } else {
        const uint32_t inv = __ballot_sync(FULL, exists && !vd);
        if (inv) {
          way = __ffs(inv) - 1;
        } else {
          const uint32_t key = exists ? ((lru << 5) | lane) : FULL;
          way = static_cast<int>(__reduce_min_sync(FULL, key) & 31u);
        }
        evict_wb = __shfl_sync(FULL, static_cast<int>(vd && dt), way) != 0;
      }
      if (lane == way) {
        if (hit) {
          dt = dt || wr;
        } else {
          tg = rt;
          vd = true;
          dt = wr;
        }
        lru = LRU_MAX;
      } else {
        lru = sat_dec(lru);
      }

      if (m) {  // request_stats, conventional side
        const int wb = (!hit && evict_wb) ? 1 : 0;
        acc.i[I_CONV_HITS] += hit ? 1 : 0;
        acc.i[I_CONV_MISSES] += hit ? 0 : 1;
        acc.i[I_DRAM] += hit ? 0 : 1;
        acc.i[I_WB] += wb;
        acc.f[F_LAT] += hit ? c.lat_ch : c.lat_cm;
        float e = c.e_conv;
        if (!hit) e += c.e_dram;
        if (wb > 0) e += static_cast<float>(wb) * c.e_dram;
        acc.f[F_ENERGY] += e;
        acc.f[F_CONV_BYTES] += static_cast<float>(BLOCK_BYTES);
        float db = hit ? 0.f : static_cast<float>(BLOCK_BYTES);
        if (wb > 0) db += static_cast<float>(wb) * BLOCK_BYTES;
        acc.f[F_DRAM_BYTES] += db;
      }
    }
  }

  write_stats(acc, set, a.ints, a.flts, lane);
  if (a.tags1 != nullptr && exists) {
    a.tags1[row] = tg;
    a.valid1[row] = vd;
    a.dirty1[row] = dt;
    a.lru1[row] = lru;
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

// repro/core/bloom.py: h = tag * m (mod 2^32); h ^= h >> 15; bit = h % 256
__device__ __forceinline__ void hash_bits(uint32_t tag, uint32_t (&hb)[3]) {
  const uint32_t mult[3] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t h = tag * mult[i];
    h ^= h >> 15;
    hb[i] = h % BLOOM_BITS;
  }
}

// Every lane holds all 8 words; the unrolled selects keep them in
// registers (no dynamically indexed local memory).
__device__ __forceinline__ bool bloom_test(const uint32_t (&bf)[BLOOM_WORDS],
                                           const uint32_t (&hb)[3]) {
  bool present = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t w = 0u;
#pragma unroll
    for (int q = 0; q < BLOOM_WORDS; ++q)
      if ((hb[i] >> 5) == static_cast<uint32_t>(q)) w = bf[q];
    present = present && ((w >> (hb[i] & 31u)) & 1u);
  }
  return present;
}

template <int K>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
ext_scan_kernel(const ExtArgs a) {
  constexpr int SHIFT = (K <= 4) ? 7 : 8;  // way index bits in a min key
  const int lane = threadIdx.x & 31;
  const long set = static_cast<long>(blockIdx.x) * WARPS_PER_BLOCK +
                   (threadIdx.x >> 5);
  if (set >= a.n_sets) return;  // warp-uniform

  uint32_t tg[K], lru[K];
  int32_t sz[K];
  bool vd[K], dt[K], ex[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int way = k * 32 + lane;
    ex[k] = way < a.W;
    tg[k] = 0u;
    lru[k] = 0u;
    sz[k] = 0;
    vd[k] = false;
    dt[k] = false;
    if (a.tags0 != nullptr && ex[k]) {
      const long r = set * a.W + way;
      tg[k] = a.tags0[r];
      vd[k] = a.valid0[r] != 0;
      dt[k] = a.dirty0[r] != 0;
      lru[k] = a.lru0[r];
      sz[k] = a.size0[r];
    }
  }
  uint32_t bf1[BLOOM_WORDS], bf2[BLOOM_WORDS];
  int used = 0, nmru = 0;
#pragma unroll
  for (int q = 0; q < BLOOM_WORDS; ++q) {
    bf1[q] = a.tags0 != nullptr ? a.bf1_0[set * BLOOM_WORDS + q] : 0u;
    bf2[q] = a.tags0 != nullptr ? a.bf2_0[set * BLOOM_WORDS + q] : 0u;
  }
  if (a.tags0 != nullptr) {
    used = a.used0[set];
    nmru = a.nmru0[set];
  }

  Acc acc = {};
  const Costs c = a.c;
  const long base = set * a.L;

  for (int t0 = 0; t0 < a.L; t0 += 32) {
    uint32_t c_tag, c_flags;
    load_chunk(a.tag, a.write, a.level, a.active, a.mask, base, t0 + lane,
               a.L, c_tag, c_flags);
    uint32_t todo = __ballot_sync(FULL, (c_flags & 2u) != 0u);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const uint32_t rt = __shfl_sync(FULL, c_tag, j);
      const uint32_t rf = __shfl_sync(FULL, c_flags, j);
      const bool wr = rf & 1u;
      const bool m = (rf >> 2) & 1u;
      const int lv = static_cast<int>(rf >> 3);

      // lookup: first matching way
      int e_way = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t b = __ballot_sync(FULL, ex[k] && vd[k] && tg[k] == rt);
        if (e_way < 0 && b) e_way = k * 32 + __ffs(b) - 1;
      }
      const bool hit = e_way >= 0;

      uint32_t hb[3];
      hash_bits(rt, hb);
      bool pred = true;
      if (a.predictor == PRED_BLOOM) pred = bloom_test(bf1, hb);
      else if (a.predictor == PRED_PERFECT) pred = hit;

      const int phys = !a.compression ? BLOCK_BYTES
                       : lv == HIGH   ? 32
                       : lv == LOW    ? 64
                                      : BLOCK_BYTES;
      int wbs = 0;
      if (hit) {  // touch: Algorithm 1 lines 8-12
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k * 32 + lane == e_way) {
            lru[k] = LRU_MAX;
            dt[k] = dt[k] || wr;
          } else {
            lru[k] = sat_dec(lru[k]);
          }
        }
      } else {  // insert: LRU-evict until the block fits
        for (int it = 0; it < MAX_EVICTIONS; ++it) {
          bool any_valid = false;
#pragma unroll
          for (int k = 0; k < K; ++k)
            any_valid = any_valid || __any_sync(FULL, vd[k]);
          if (used + phys <= a.budget || !any_valid) break;
          uint32_t best = FULL;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const uint32_t key = vd[k] ? lru[k] : (LRU_MAX + 1u);
            const uint32_t comp =
                (key << SHIFT) | static_cast<uint32_t>(k * 32 + lane);
            if (ex[k] && comp < best) best = comp;
          }
          best = __reduce_min_sync(FULL, best);
          const int v = static_cast<int>(best & ((1u << SHIFT) - 1u));
          const int vk = v >> 5, vl = v & 31;
          int vdirty = 0, vsize = 0;
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (k == vk) {
              vdirty = dt[k];
              vsize = sz[k];
            }
          vdirty = __shfl_sync(FULL, vdirty, vl);
          vsize = __shfl_sync(FULL, vsize, vl);
          wbs += vdirty;
          used -= vsize;
          if (lane == vl) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (k == vk) {
                vd[k] = false;
                dt[k] = false;
                sz[k] = 0;
              }
          }
        }
        // free way: first invalid way, way 0 when none (jnp.argmax rule)
        int fw = -1;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint32_t b = __ballot_sync(FULL, ex[k] && !vd[k]);
          if (fw < 0 && b) fw = k * 32 + __ffs(b) - 1;
        }
        if (fw < 0) fw = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k * 32 + lane == fw) {
            tg[k] = rt;
            vd[k] = true;
            dt[k] = wr;
            sz[k] = phys;
            lru[k] = LRU_MAX;
          } else {
            lru[k] = sat_dec(lru[k]);
          }
        }
        used += phys;
      }

      // Bloom maintenance (Fig. 6(b))
      bool swap = false;
      if (a.predictor == PRED_BLOOM) {
        const bool in_bf2 = bloom_test(bf2, hb);
#pragma unroll
        for (int q = 0; q < BLOOM_WORDS; ++q) {
          uint32_t mq = 0u;
#pragma unroll
          for (int i = 0; i < 3; ++i)
            if ((hb[i] >> 5) == static_cast<uint32_t>(q))
              mq |= 1u << (hb[i] & 31u);
          bf1[q] |= mq;
          bf2[q] |= mq;
        }
        nmru += in_bf2 ? 0 : 1;
        if (nmru >= a.ext_ways) {
          swap = true;
#pragma unroll
          for (int q = 0; q < BLOOM_WORDS; ++q) {
            bf1[q] = bf2[q];
            bf2[q] = 0u;
          }
          nmru = 0;
        }
      }

      if (m) {  // request_stats, extended side
        const bool hit_e = hit;
        const bool fp = !hit && pred;
        const bool pm = !pred;
        const bool miss = !hit;
        const int wb = miss ? wbs : 0;
        acc.i[I_EXT_HITS] += hit_e;
        acc.i[I_EXT_FP] += fp;
        acc.i[I_EXT_PM] += pm;
        acc.i[I_EXT_TRUE_MISS] += miss;
        acc.i[I_DRAM] += miss;
        acc.i[I_WB] += wb;
        acc.i[I_SWAPS] += (a.predictor == PRED_BLOOM && swap) ? 1 : 0;
        float lat = 0.f;
        if (hit_e) lat += c.lat_eh;
        if (fp) lat += c.lat_em;
        if (pm) lat += c.lat_pm;
        acc.f[F_LAT] += lat;
        float e = 0.f;
        if (hit_e || fp) e += c.e_ext;
        if (pm) e += c.e_ext_pm;
        if (miss) e += c.e_dram;
        if (wb > 0) e += static_cast<float>(wb) * c.e_dram;
        acc.f[F_ENERGY] += e;
        const int noc = ((hit_e || fp) ? 1 : 0) + (miss ? 1 : 0) + wb;
        acc.f[F_NOC] += static_cast<float>(noc * BLOCK_BYTES);
        float db = miss ? static_cast<float>(BLOCK_BYTES) : 0.f;
        if (wb > 0) db += static_cast<float>(wb) * BLOCK_BYTES;
        acc.f[F_DRAM_BYTES] += db;
      }
    }
  }

  write_stats(acc, set, a.ints, a.flts, lane);
  if (a.tags1 != nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int way = k * 32 + lane;
      if (ex[k]) {
        const long r = set * a.W + way;
        a.tags1[r] = tg[k];
        a.valid1[r] = vd[k];
        a.dirty1[r] = dt[k];
        a.lru1[r] = lru[k];
        a.size1[r] = sz[k];
      }
    }
    if (lane < BLOOM_WORDS) {
#pragma unroll
      for (int q = 0; q < BLOOM_WORDS; ++q)
        if (q == lane) {
          a.bf1_1[set * BLOOM_WORDS + q] = bf1[q];
          a.bf2_1[set * BLOOM_WORDS + q] = bf2[q];
        }
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
  const unsigned grid = blocks_for(n_sets);
  const unsigned block = WARPS_PER_BLOCK * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 32) ext_scan_kernel<1><<<grid, block, 0, s>>>(a);
  else if (W <= 64) ext_scan_kernel<2><<<grid, block, 0, s>>>(a);
  else if (W <= 128) ext_scan_kernel<4><<<grid, block, 0, s>>>(a);
  else ext_scan_kernel<8><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
