// The two attention kernels for Hopper (sm_90a): the hand-written CUDA
// counterparts of the Pallas kernels of src/repro/kernels/.
//
//   flash_kernel_bf16<D, LSE> <- _flash_kernel (flash_attn.py:47, called
//   flash_kernel_f32<D, LSE>     at :128): one entry point, two designs
//   decode_partial_kernel<..> <- _decode_kernel (decode_attn.py:26, called
//   decode_combine_kernel        at :87), split over chunks of T
//
// Semantics (all kernels, as the reference): online softmax in f32; a
// masked logit is NEG = -2e38 (never -inf), so a row whose every key is
// masked averages v uniformly, and a row with one valid key wipes the
// masked ones out (exp(NEG - m) == 0 in f32); keys past the end of the
// sequence are left out altogether.  GQA: query head h reads KV head h / G
// (H = KV * G).  The softmax runs in base 2: a logit becomes x * log2(e)
// (after the scale and the soft cap) and 2^x replaces e^x, which leaves
// every ratio as it is; the denominator is max(l, 1e-30).
//
// Both flash designs give a block the rows (query position, head) of the
// G heads of one KV head for BM / G positions, so each K/V tile is read
// once for the group; walk the K/V tiles of BK = 64 keys in a loop (the
// Pallas grid's sequential axis); skip the tiles the causal and window
// masks remove for every row (unless some row of the block has no key: it
// then averages all T keys, as the reference does); mask only the tiles
// that cross a boundary; order the blocks longest first (under a causal
// mask the last positions have the most keys); and copy K and V in by
// 16-byte cp.async, whose addresses step linearly from offsets computed
// once.  Head dims are compile-time ceilings D in {64, 128, 256}; the copy
// zero-fills the columns past hd (hdv), so the d loops have fixed bounds.
// The wrapper pads head dims to a multiple of 16 (a zero column changes no
// dot product).  With LSE the epilogue also stores each row's base-2
// log-sum-exp m + log2(l) for the backward (attention_bwd.cu); without it
// (serving, under no_grad) the kernel is what it was before the flag.
// The pieces both flash sources share are in flash_common.cuh.
//
// flash_kernel_bf16: bound by operations on the tensor cores (989
// TFLOP/s dense bf16; the serving shape's causal S = T = 1024 is 69 GFLOP
// against 34 MB).  Two warpgroups of 64 rows (BM = 128), two blocks an SM
// up to D = 128.  S = Q K^T is wgmma.mma_async m64n64k16 with Q and K
// from shared memory (K-major descriptors); O += P V is m64nDk16 with P
// from registers and V from shared memory through the MN-major
// (transposed) descriptor; f32 accumulators.  Tiles are stored in 64-column
// blocks with the 128-byte swizzle the descriptors name.  K and V have two
// buffers each: tile t + 1 is copied in while tile t is multiplied.  The
// online softmax runs on the accumulator fragments in registers (row max
// and sum over the lane quad by shuffles, 2^x on the special-function
// unit, the scale folded into its FMA on unmasked tiles), and P is
// rounded to bf16 in registers, where two n8 score tiles already form the
// A fragment of the next product.  Rounding P to bf16 is the usual
// tensor-core choice; its relative error, 2^-9 an element, stays far
// inside the bf16 tolerance 3e-2 (the sum l is taken over the f32 P).
// Copies are cp.async, not TMA, and the warpgroups are not specialised:
// both are later work.
//
// flash_kernel_f32: full f32 on the CUDA cores (TF32 would not hold the
// f32 tolerances), bound by operations at 67 TFLOP/s.  A CUDA-core tile
// loop is bound by shared-memory bandwidth per FMA, so the design is
// register tiling as in an SGEMM: 16 x 16 threads (8 x 16 at D = 256),
// each owning 8 rows x 4 keys of the score tile and 8 rows x D/16 value
// columns of the accumulator, read by 16-byte shared loads (Q rows padded
// by 4 floats every 8 rows, K rows by 4 floats: no bank conflicts); each
// loaded value feeds 4 or 8 FMAs.  One K and one V buffer, their copies
// offset by half a tile (K of tile t + 1 lands during P.V of tile t, V of
// tile t + 1 during the scores of tile t + 1).  The 16 threads that share
// a row sit in one half-warp, so the row max and sum are shuffles and P
// goes through a per-warp shared tile.
//
// decode: flash-decoding, bound by device-memory bytes (one query token
// reads its whole K/V once).  A partial kernel gives a block to (b, KV
// head, chunk of keys; attention.py::decode_chunk picks the chunk so that
// there are 2 blocks an SM or more) and streams the chunk's K tiles, then
// its V tiles, through a 3-stage ring of 16-byte cp.async copies, so two
// tiles are always in flight a block (16 KB in f32 at hd 128); invalid
// keys of a chunk with a valid key are not read at all (their weight is
// exp(NEG - m) == 0).  The chunk keeps all its logits, so its softmax is
// taken once between the K and the V tiles.  Two designs:
//   decode_partial_kernel<T, GB, Cfg> (CUDA cores; f32, and bf16 where the
//     tensor-core one does not apply): PARTS neighbouring lanes a key, each
//     loaded K element feeding a pass of GB <= 8 heads, the parts summed
//     by log2(PARTS) shuffles (no 5-step reduction a key and head); in P.V
//     a thread owns 4 value columns of every head of the pass for a slice
//     of the keys, the slices summed through shared memory.  256 threads
//     a block in f32, 128 in bf16 (the faster of those measured).
//   decode_partial_kernel_tc<Cfg> (bf16, G <= 16, hd a multiple of 64):
//     both products as mma.sync m16n8k16 with q padded to 16 rows, K and
//     V fragments by ldmatrix (.trans for V) from the ring; per byte this
//     takes a fraction of the CUDA-core design's instructions, which
//     bound bf16 when K/V sit in L2.
// decode_combine_kernel merges the chunks and divides by max(l, 1e-30).
//
// Types: q, k, v (and flash's output) are float or bf16; everything is
// accumulated in f32; decode's output is f32.  Plain C interface (loaded
// with ctypes): each launcher returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take) and launches on the
// caller's stream.  Pointers must be 16-byte aligned and head dims
// multiples of 16 (the wrapper pads and aligns).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

constexpr int MAX_HEAD_DIM = 256;

constexpr int MAX_GROUP = 64;      // query heads a KV head, at most
constexpr int COMBINE_THREADS = 128;
constexpr int DEC_GB = 8;          // heads a pass over v
constexpr int DEC_MAX_CHUNK = 256;

constexpr float NEG = -2.0e38f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------- flash, both designs

// The keys [k_lo, k_hi] any row of the block attends to, and whether
// some row has none (the block then walks and masks every key).  Row qp
// sees [max(0, qp - window + 1), causal ? min(T - 1, qp) : T - 1]; both
// ends are nondecreasing in qp and a row is empty only past T + window,
// so the last row decides.
struct KeyRange {
  int lo, hi;
  bool all;
};

__device__ __forceinline__ KeyRange key_range(int q0, int q_last, int Tk,
                                              int causal, int window) {
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(Tk - 1, q_last) : Tk - 1;
  if (lo_last > hi_last) return {0, Tk - 1, true};
  return {window > 0 ? max(0, q0 - window + 1) : 0, hi_last, false};
}

// Whether tile [k0, k0 + BK) needs the masks for some row of the block.
__device__ __forceinline__ bool tile_masked(const KeyRange& kr, int k0,
                                            int q0, int q_last, int Tk,
                                            int causal, int window) {
  return kr.all || k0 + BK > Tk || (causal && k0 + BK - 1 > q0) ||
         (window > 0 && k0 <= q_last - window);
}

// A raw score in the base-2 domain, with no masks (decode applies its
// validity mask itself).
__device__ __forceinline__ float scaled2(float s, const LogitScale& ls) {
  return ls.cap > 0.f ? ls.cap * tanhf(s * ls.inv) : s * ls.mul;
}

// One logit in the base-2 domain, then the masks (masked: NEG; past T:
// -inf, left out).
__device__ __forceinline__ float logit2(float s, const LogitScale& ls,
                                        bool masked, int qp, int kp, int Tk,
                                        int causal, int window) {
  const float x = scaled2(s, ls);
  if (masked) {
    if (kp >= Tk) return -INFINITY;
    bool ok = true;
    if (causal) ok = kp <= qp;
    if (window > 0) ok = ok && qp - kp < window;
    if (!ok) return NEG;
  }
  return x;
}

// Q row r starts at r * D + (r / 8) * 4: rows 8 apart, which share a
// warp's 16-byte loads, land on different banks.
template <int D> __device__ __forceinline__ int q_row(int r) {
  return r * D + (r >> 3) * 4;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b, mma.sync m16n8k16, bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int TC_WGS = 2;            // warpgroups (of 64 rows) a block
constexpr int TC_BM = 64 * TC_WGS;   // rows a block
constexpr int TC_THREADS = 128 * TC_WGS;

// Q (TC_BM rows), then two K and two V tiles of BK keys; 1 KB of slack
// for the 1024-byte alignment the 128-byte swizzle needs.
template <int D> constexpr int tc_smem_bytes() {
  return static_cast<int>(sizeof(bf16)) * (TC_BM + 4 * BK) * D + 1024;
}

// Warpgroup g owns block rows 64g..64g+63, its warp w rows 64g + 16w..+15;
// lane l holds rows 64g + 16w + l/4 (i = 0) and + 8 (i = 1), in the score
// fragment of n8 tile nt the keys 8nt + 2(l%4) + {0, 1}, in the output
// fragment of n8 tile nd the value columns 8nd + 2(l%4) + {0, 1}.  K and
// V of tile t + 1 are copied in while tile t runs (two buffers each).
// Two blocks share an SM up to D = 128.
template <int D, bool LSE>
__global__ void __launch_bounds__(TC_THREADS, D <= 128 ? 2 : 1)
flash_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, int S,
                  int Tk, int H, int KV, int hd, int hdv, int G, int bq,
                  int n_qt, int causal, int window, float softcap,
                  float scale) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023));
  bf16* Kbuf = Qs + TC_BM * D;
  bf16* Vbuf = Kbuf + 2 * BK * D;

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = (n_qt - 1 - blockIdx.x) * bq;
  const int rows = bq * G;
  const int q_last = min(q0 + bq, S) - 1;
  const KeyRange kr = key_range(q0, q_last, Tk, causal, window);
  const int t_begin = kr.lo / BK, t_end = kr.hi / BK;
  const LogitScale ls = logit_scale(scale, softcap);

  auto kslot = [&](int t) { return Kbuf + (t & 1) * BK * D; };
  auto vslot = [&](int t) { return Vbuf + (t & 1) * BK * D; };
  auto load_tile = [&](int t) {
    bf16* kb = kslot(t);
    bf16* vb = vslot(t);
    load_kv<bf16, D, TC_THREADS>(
        k, b, Tk, KV, kvh, hd, t * BK,
        [&](int r, int c) { return sw128(kb, r, c); });
    load_kv<bf16, D, TC_THREADS>(
        v, b, Tk, KV, kvh, hdv, t * BK,
        [&](int r, int c) { return sw128(vb, r, c); });
  };
  load_q<bf16, D, TC_BM, TC_THREADS>(
      q, b, S, H, kvh, G, hd, q0, rows,
      [&](int r, int c) { return sw128(Qs + (r >> 6) * 64 * D, r & 63, c); });
  load_tile(t_begin);
  cp_commit();

  const bf16* Qw = Qs + wg * 64 * D;
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * wg + warp * 16 + (lane >> 2) + 8 * i;
    qpos[i] = q0 + r / G;
    row_ok[i] = r < rows && qpos[i] < S;
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * BK;
    if (t < t_end) load_tile(t + 1);       // rides along tile t
    cp_commit();
    cp_wait<1>();
    fence_async_shared();                  // the copies, seen by wgmma
    __syncthreads();                       // Q, K and V of tile t are in
    const bf16* Ks = kslot(t);
    const bf16* Vs = vslot(t);

    // S = Q K^T: Q and K K-major, 16 columns a step
    float s[BK / 2] = {};
    wg_arrive();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk * 16 >= hd) break;            // zero columns: no product
      const int off = (kk >> 2) * 64 * 64 + (kk & 3) * 16;
      wgmma_ss_n64(s, gmma_desc(Qw + off, 16, 1024),
                   gmma_desc(Ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();

    // online softmax on the fragments, rows reduced over the lane quad;
    // on a tile with no mask and no cap the scale rides in the exponent's
    // FMA (the max of s * scale is scale * max(s))
    const bool masked =
        tile_masked(kr, k0, q0, q_last, Tk, causal, window);
    const bool raw = !masked && ls.cap == 0.f;
    const float mul = raw ? ls.mul : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * nt + 2 * i + e];
          if (!raw)
            x = logit2(x, ls, masked, qpos[i], k0 + 8 * nt + 2 * (lane & 3)
                       + e, Tk, causal, window);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * mul);
      const float alpha = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * nt + 2 * i + e];
          x = fast_exp2(fmaf(x, mul, -m_new));
          sum += x;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[4 * nd + 2 * i] *= alpha;
        o[4 * nd + 2 * i + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 in registers (two n8 score tiles are
    // one k16 A fragment), V the MN-major B operand: 64-column blocks 8 KB
    // apart (LBO), 8-key row groups 1 KB apart (SBO)
    wg_arrive();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      PV<D>::mma(o, a, gmma_desc(Vs + kk * 16 * 64, 64 * 128, 1024));
    }
    wg_commit();
    wg_wait<0>();
    __syncthreads();                       // both buffers of tile t free
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (!row_ok[i]) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int r = 64 * wg + warp * 16 + (lane >> 2) + 8 * i;
    const long long row = (static_cast<long long>(b) * S + qpos[i]) * H +
                          kvh * G + r % G;
    if (LSE && (lane & 3) == 0) lse[row] = m[i] + log2f(lt);
    bf16* dst = out + row * hdv;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = 8 * nd + 2 * (lane & 3);
      if (c < hdv)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
            o[4 * nd + 2 * i] * inv, o[4 * nd + 2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------ flash, f32, CUDA cores

template <int D> struct F32Tile {
  static constexpr int BM = D <= 128 ? 128 : 64;    // rows a block
  static constexpr int NT = BM / 8 * 16;            // threads
  static constexpr int CV = D / 16;                 // value columns a thread
  static constexpr int LDK = D + 4;                 // K/V row stride
  static constexpr int LDP = BM + 4;                // P row stride
  static constexpr int QF = BM * D + BM / 8 * 4;    // Q floats
  static constexpr int SMEM =
      static_cast<int>(sizeof(float)) * (QF + 2 * BK * LDK + BK * LDP);
};


// Thread (rg, kg) = (tid / 16, tid % 16) owns rows 8rg + i (i < 8); in
// the scores keys kg + 16j (j < 4), in the accumulator value columns
// 4kg + 64jj + e (jj < D / 64, e < 4).
template <int D, bool LSE>
__global__ void __launch_bounds__(F32Tile<D>::NT)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S,
                 int Tk, int H, int KV, int hd, int hdv, int G, int bq,
                 int n_qt, int causal, int window, float softcap,
                 float scale) {
  using C = F32Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + C::QF;
  float* Vs = Ks + BK * C::LDK;
  float* Ps = Vs + BK * C::LDK;     // [key][row]; a warp's rows are its own

  const int tid = threadIdx.x, rg = tid >> 4, kg = tid & 15;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = (n_qt - 1 - blockIdx.x) * bq;
  const int rows = bq * G;
  const int q_last = min(q0 + bq, S) - 1;
  const KeyRange kr = key_range(q0, q_last, Tk, causal, window);
  const int t_begin = kr.lo / BK, t_end = kr.hi / BK;
  const LogitScale ls = logit_scale(scale, softcap);

  auto qdst = [&](int r, int c) { return Qs + q_row<D>(r) + 4 * c; };
  auto kdst = [&](int r, int c) { return Ks + r * C::LDK + 4 * c; };
  auto vdst = [&](int r, int c) { return Vs + r * C::LDK + 4 * c; };
  load_q<float, D, C::BM, C::NT>(q, b, S, H, kvh, G, hd, q0, rows, qdst);
  load_kv<float, D, C::NT>(k, b, Tk, KV, kvh, hd, t_begin * BK, kdst);
  cp_commit();
  load_kv<float, D, C::NT>(v, b, Tk, KV, kvh, hdv, t_begin * BK, vdst);
  cp_commit();

  float m[8], l[8], acc[8][C::CV];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CV; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * BK;
    cp_wait<1>();
    __syncthreads();                       // Q and K of tile t are in

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (kg + 16 * j) * C::LDK
                                                 + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + q_row<D>(8 * rg + i) + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    __syncthreads();                       // every warp is done with K
    if (t < t_end) load_kv<float, D, C::NT>(k, b, Tk, KV, kvh, hd, k0 + BK,
                                            kdst);
    cp_commit();

    // online softmax in registers, rows reduced over the half-warp
    const bool masked =
        tile_masked(kr, k0, q0, q_last, Tk, causal, window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + (8 * rg + i) / G;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = logit2(s[i][j], ls, masked, qp, k0 + kg + 16 * j, Tk,
                         causal, window);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fast_exp2(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < C::CV; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(Ps + (kg + 16 * j) * C::LDP + 8 * rg +
                                   4 * h) =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                        s[4 * h + 3][j]);

    cp_wait<1>();
    __syncthreads();                       // V of tile t is in, P written
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(Ps + kk * C::LDP + 8 * rg);
      const float4 p1 =
          *reinterpret_cast<const float4*>(Ps + kk * C::LDP + 8 * rg + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + kk * C::LDK + 4 * kg + 64 * jj);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * jj] = fmaf(p[i], vv.x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(p[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
    __syncthreads();                       // every warp is done with V, P
    if (t < t_end) load_kv<float, D, C::NT>(v, b, Tk, KV, kvh, hdv, k0 + BK,
                                            vdst);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const int r = 8 * rg + i;
    const int qp = q0 + r / G;
    if (r >= rows || qp >= S) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const long long row = (static_cast<long long>(b) * S + qp) * H +
                          kvh * G + r % G;
    if (LSE && kg == 0) lse[row] = m[i] + log2f(lt);
    float* dst = out + row * hdv;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const int c = 4 * kg + 64 * jj;
      if (c < hdv)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                        acc[i][4 * jj + 2] * inv, acc[i][4 * jj + 3] * inv);
    }
  }
}

// ------------------------------------------------------ flash launchers

template <int D>
cudaError_t flash_f32(const void* q, const void* k, const void* v,
                      void* out, float* lse, int B, int S, int Tk, int H,
                      int KV, int hd, int hdv, int causal, int window,
                      float softcap, float scale, cudaStream_t stream) {
  using C = F32Tile<D>;
  static_assert(C::SMEM <= MAX_SMEM, "f32 flash tile exceeds shared memory");
  const int G = H / KV;
  const int bq = C::BM / G;
  const int n_qt = (S + bq - 1) / bq;
  auto kernel = lse ? flash_kernel_f32<D, true> : flash_kernel_f32<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, KV, B), C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Tk, H,
      KV, hd, hdv, G, bq, n_qt, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t flash_bf16(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int S, int Tk, int H,
                       int KV, int hd, int hdv, int causal, int window,
                       float softcap, float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>();
  static_assert(smem <= MAX_SMEM, "bf16 flash tile exceeds shared memory");
  const int G = H / KV;
  const int bq = TC_BM / G;
  const int n_qt = (S + bq - 1) / bq;
  auto kernel =
      lse ? flash_kernel_bf16<D, true> : flash_kernel_bf16<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, KV, B), TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, Tk, H,
      KV, hd, hdv, G, bq, n_qt, causal, window, softcap, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- decode

// A decode block's shape: NT threads, tiles of SK keys, NS stages.
template <int NT_, int SK_, int NS_> struct DecCfg {
  static constexpr int NT = NT_, SK = SK_, NS = NS_;
  static constexpr int PARTS = NT / SK;    // threads a key in the logits
  static constexpr int WARPS = NT / 32;
};

template <typename T, typename C> struct DecodeSmem {
  static constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte copy
  // The ring of C::NS tiles of C::SK rows (rows padded by 16 bytes: the
  // logits read across the rows, C::PARTS threads a key), then q as f32,
  // the chunk's
  // logits/probabilities, the P.V slices' partial sums and the chunk's
  // validity bytes.
  __host__ __device__ static int ldk(int hd) { return hd + VEC; }
  __host__ __device__ static int slices(int hd) {
    return C::NT / (hd / 4);
  }
  __host__ __device__ static int q_off(int hd) {
    return C::NS * C::SK * ldk(hd) * static_cast<int>(sizeof(T));
  }
  __host__ __device__ static int l_off(int hd, int G) {
    return q_off(hd) + 4 * G * hd;
  }
  __host__ __device__ static int red_off(int hd, int G, int chunk) {
    return l_off(hd, G) + 4 * G * chunk;
  }
  __host__ __device__ static int ok_off(int hd, int G, int chunk, int gb) {
    return red_off(hd, G, chunk) + 4 * slices(hd) * (G < gb ? G : gb) * hd;
  }
  __host__ __device__ static int bytes(int hd, int G, int chunk, int gb) {
    return ok_off(hd, G, chunk, gb) + chunk;
  }
};

// 4 consecutive elements (or, from 16 bytes, VEC) as floats.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  f[0] = a.x; f[1] = a.y; f[2] = c.x; f[3] = c.y;
}
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  load4(p, f);
}
__device__ __forceinline__ void load16(const bf16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

// Block (chunk c, KV head kvh, batch b): keys [c * chunk, c * chunk + n).
// The chunk's K tiles, then its V tiles (once for every DEC_GB heads),
// stream through one ring of C::NS stages, C::NS - 1 tiles in flight
// ahead of the one in use.  The logits of the whole chunk are kept, so
// its softmax is taken once between the K and the V tiles (no online
// rescaling).  Partials are laid out (B, KV, chunks, G) for m and l (base
// 2) and (B, KV, chunks, G, hd) for the accumulator.
template <typename T, int GB, typename C, bool CAP>
__global__ void __launch_bounds__(C::NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ valid, int Tk, int H,
                      int KV, int hd, int G, int chunk, int n_chunks,
                      float scale, float softcap, float* __restrict__ m_out,
                      float* __restrict__ l_out,
                      float* __restrict__ acc_out) {
  using L = DecodeSmem<T, C>;
  constexpr int VEC = L::VEC;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int ldk = L::ldk(hd);
  T* ring = reinterpret_cast<T*>(dec_smem);
  float* Qs = reinterpret_cast<float*>(dec_smem + L::q_off(hd));
  float* Ls = reinterpret_cast<float*>(dec_smem + L::l_off(hd, G));
  float* Red = reinterpret_cast<float*>(dec_smem + L::red_off(hd, G, chunk));
  uint8_t* ok_s = dec_smem + L::ok_off(hd, G, chunk, GB);

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * chunk;
  const int n = min(chunk, Tk - t0);
  const long long row0 = static_cast<long long>(b) * Tk + t0;

  // A chunk with a valid key reads only its valid keys (the others weigh
  // exp(NEG - m) == 0); a chunk with none reads all its v (its mean of v
  // counts if the whole row has no valid key).
  int any = 0;
  for (int j = tid; j < n; j += C::NT) {
    const uint8_t x = valid[row0 + j];
    ok_s[j] = x;
    any |= x;
  }
  any = __syncthreads_or(any);

  const int nt = (n + C::SK - 1) / C::SK;        // tiles of K, of V
  const int ng = (G + GB - 1) / GB;        // passes over V
  const int total = nt * (1 + ng);
  const int cpr = hd / VEC;
  // a thread's copies: one 16-byte column c of rows j0, j0 + rstep, ...
  // (every hd the configs use), else the general index walk
  const bool even = C::NT % cpr == 0;
  const int cc = tid % cpr, cj0 = tid / cpr, rstep = C::NT / cpr;
  const long long rs = static_cast<long long>(KV) * hd;
  auto fetch = [=](int i) {
    if (i < total) {
      const bool is_k = i < nt;
      const int j0 = (is_k ? i : (i - nt) % nt) * C::SK;
      const int rows = min(C::SK, n - j0);
      const T* src = is_k ? k : v;
      T* dst = ring + (i % C::NS) * C::SK * ldk;
      if (even) {
        const T* s0 = src + (row0 + j0) * rs +
                      static_cast<long long>(kvh) * hd + cc * VEC;
        for (int j = cj0; j < rows; j += rstep) {
          const bool ok = (!is_k && !any) || ok_s[j0 + j] != 0;
          cp_async16(dst + j * ldk + cc * VEC, ok ? s0 + j * rs : src, ok);
        }
      } else {
        for (int e = tid; e < rows * cpr; e += C::NT) {
          const int j = e / cpr, x = e - j * cpr;
          const bool ok = (!is_k && !any) || ok_s[j0 + j] != 0;
          cp_async16(dst + j * ldk + x * VEC,
                     ok ? src + ((row0 + j0 + j) * KV + kvh) * hd + x * VEC
                        : src,
                     ok);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < C::NS - 1; ++i) fetch(i);
  const T* qb = q + (static_cast<long long>(b) * H + kvh * G) * hd;
  for (int e = tid; e < G * hd; e += C::NT) Qs[e] = to_f(qb[e]);

  // CAP: scale then cap (tanh) a logit; else only scale it
  const LogitScale ls = logit_scale(scale, softcap);
  const float sl = scale * LOG2E;
  const long long stat0 =
      ((static_cast<long long>(b) * KV + kvh) * n_chunks + c) * G;
  const int key = tid / C::PARTS, part = tid % C::PARTS;
  const int cgs = hd / 4, slices = L::slices(hd);
  const int cg = tid % cgs, slice = tid / cgs;
  float acc[GB][4];
#pragma unroll
  for (int gg = 0; gg < GB; ++gg)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gg][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    fetch(i + C::NS - 1);
    cp_wait<C::NS - 1>();
    __syncthreads();                       // tile i is in (and q)
    const T* tile = ring + (i % C::NS) * C::SK * ldk;
    if (i < nt) {
      // logits: C::PARTS neighbouring lanes a key, each K element read
      // once for GB heads, the parts summed by shuffles
      const int j = i * C::SK + key;
      for (int g0 = 0; g0 < G; g0 += GB) {
        float s[GB];
#pragma unroll
        for (int gg = 0; gg < GB; ++gg) s[gg] = 0.f;
        if (j < n) {
#pragma unroll 4
          for (int x = part; x < cpr; x += C::PARTS) {
            float kf[VEC];
            load16(tile + key * ldk + x * VEC, kf);
#pragma unroll
            for (int gg = 0; gg < GB; ++gg) {
              if (g0 + gg < G) {
                const float* qr = Qs + (g0 + gg) * hd + x * VEC;
#pragma unroll
                for (int u = 0; u < VEC; u += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qr + u);
                  s[gg] = fmaf(qv.x, kf[u], s[gg]);
                  s[gg] = fmaf(qv.y, kf[u + 1], s[gg]);
                  s[gg] = fmaf(qv.z, kf[u + 2], s[gg]);
                  s[gg] = fmaf(qv.w, kf[u + 3], s[gg]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int gg = 0; gg < GB; ++gg) {
          if (g0 + gg >= G) break;
#pragma unroll
          for (int o = 1; o < C::PARTS; o <<= 1)
            s[gg] += __shfl_xor_sync(0xffffffffu, s[gg], o);
          if (part == 0 && j < n)
            Ls[(g0 + gg) * chunk + j] =
                ok_s[j] ? (CAP ? scaled2(s[gg], ls) : s[gg] * sl) : NEG;
        }
      }
      if (i == nt - 1) {
        __syncthreads();                   // every logit of the chunk
        for (int g = warp; g < G; g += C::WARPS) {   // a warp a head
          float* sr = Ls + g * chunk;
          float mx = -INFINITY;
          for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, sr[jj]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          float sum = 0.f;
          for (int jj = lane; jj < n; jj += 32) {
            const float p = fast_exp2(sr[jj] - mx);
            sr[jj] = p;
            sum += p;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane == 0) {
            m_out[stat0 + g] = mx;
            l_out[stat0 + g] = sum;
          }
        }
      }
    } else {
      // P.V: a thread owns value columns 4cg..4cg+3 of GB heads for
      // the tile's keys jj == slice (mod slices)
      const int vi = i - nt, g0 = (vi / nt) * GB, tv = vi % nt;
      const int j0 = tv * C::SK, rows = min(C::SK, n - j0);
      if (slice < slices) {
#pragma unroll 4
        for (int jj = slice; jj < rows; jj += slices) {
          float vf[4];
          load4(tile + jj * ldk + 4 * cg, vf);
#pragma unroll
          for (int gg = 0; gg < GB; ++gg) {
            if (g0 + gg < G) {
              const float p = Ls[(g0 + gg) * chunk + j0 + jj];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[gg][e] = fmaf(p, vf[e], acc[gg][e]);
            }
          }
        }
      }
      if (tv == nt - 1) {                  // this pass's heads are done
        const int gn = min(GB, G - g0);
        if (slice < slices) {
#pragma unroll
          for (int gg = 0; gg < GB; ++gg) {
            if (gg < gn)
              *reinterpret_cast<float4*>(Red + (slice * gn + gg) * hd +
                                         4 * cg) =
                  make_float4(acc[gg][0], acc[gg][1], acc[gg][2],
                              acc[gg][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[gg][e] = 0.f;
          }
        }
        __syncthreads();
        for (int e = tid; e < gn * hd; e += C::NT) {
          const int gg = e / hd, d = e - gg * hd;
          float sum = 0.f;
          for (int s2 = 0; s2 < slices; ++s2)
            sum += Red[(s2 * gn + gg) * hd + d];
          acc_out[(stat0 + g0 + gg) * hd + d] = sum;
        }
      }
    }
    __syncthreads();                       // the ring slot can be refilled
  }
  cp_wait<0>();
}

// decode_partial_kernel with both products on the tensor cores (bf16, G
// <= 16 heads padded to the 16 rows of mma.sync m16n8k16, hd a multiple
// of 64).  The same ring of K tiles then V tiles, of 64 keys; warp w takes
// keys 16w..16w+15 of a K tile (S = q K^T, q's A fragments loaded once
// by ldmatrix, K's B fragments by ldmatrix) and value columns
// w hd/4..(w+1) hd/4 - 1 of the V tiles (O += P V, P's A fragments from
// the chunk's probabilities rounded to bf16, V's B fragments by
// ldmatrix.trans), so no slice sums are needed.
template <typename C, bool CAP>
__global__ void __launch_bounds__(C::NT)
decode_partial_kernel_tc(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const uint8_t* __restrict__ valid, int Tk, int H,
                         int KV, int hd, int G, int chunk, int n_chunks,
                         float scale, float softcap,
                         float* __restrict__ m_out,
                         float* __restrict__ l_out,
                         float* __restrict__ acc_out) {
  static_assert(C::NT == 128 && C::SK == 64, "4 warps, 16 keys a warp");
  constexpr int VEC = 8;
  extern __shared__ __align__(16) unsigned char dtc_smem[];
  const int ldk = hd + VEC;                // rows 16 bytes apart in banks
  bf16* ring = reinterpret_cast<bf16*>(dtc_smem);
  bf16* Qs = ring + C::NS * C::SK * ldk;   // 16 rows of ldk, zero past G
  float* Ls = reinterpret_cast<float*>(Qs + 16 * ldk);
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(Ls + G * chunk);

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * chunk;
  const int n = min(chunk, Tk - t0);
  const long long row0 = static_cast<long long>(b) * Tk + t0;

  int any = 0;
  for (int j = tid; j < n; j += C::NT) {
    const uint8_t x = valid[row0 + j];
    ok_s[j] = x;
    any |= x;
  }
  any = __syncthreads_or(any);

  const int nt = (n + C::SK - 1) / C::SK;
  const int total = 2 * nt;
  const int cpr = hd / VEC;                // a power of two, <= 32
  const int cc = tid % cpr, cj0 = tid / cpr, rstep = C::NT / cpr;
  const long long rs = static_cast<long long>(KV) * hd;
  auto fetch = [=](int i) {
    if (i < total) {
      const bool is_k = i < nt;
      const int j0 = (is_k ? i : i - nt) * C::SK;
      const int rows = min(C::SK, n - j0);
      const bf16* src = is_k ? k : v;
      bf16* dst = ring + (i % C::NS) * C::SK * ldk;
      const bf16* s0 = src + (row0 + j0) * rs +
                       static_cast<long long>(kvh) * hd + cc * VEC;
      for (int j = cj0; j < C::SK; j += rstep) {   // rows past n: zeros
        const bool ok = j < rows && ((!is_k && !any) || ok_s[j0 + j] != 0);
        cp_async16(dst + j * ldk + cc * VEC, ok ? s0 + j * rs : src, ok);
      }
    }
    cp_commit();
  };
  const bf16* qb = q + (static_cast<long long>(b) * H + kvh * G) * hd;
  for (int e = tid; e < 16 * cpr; e += C::NT) {   // with tile 0's copies
    const int r = e / cpr, x = e - r * cpr;
    cp_async16(Qs + r * ldk + x * VEC, r < G ? qb + r * hd + x * VEC : qb,
               r < G);
  }
#pragma unroll
  for (int i = 0; i < C::NS - 1; ++i) fetch(i);

  // CAP: scale then cap (tanh) a logit; else only scale it
  const LogitScale ls = logit_scale(scale, softcap);
  const float sl = scale * LOG2E;
  const long long stat0 =
      ((static_cast<long long>(b) * KV + kvh) * n_chunks + c) * G;
  const int gr = lane >> 2;                // fragment rows gr, gr + 8
  const int cw = warp * (hd / 4);          // this warp's value columns
  uint32_t qa[MAX_HEAD_DIM / 16][4];
  float o[MAX_HEAD_DIM / 32][4];
#pragma unroll
  for (int nd = 0; nd < MAX_HEAD_DIM / 32; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    fetch(i + C::NS - 1);
    cp_wait<C::NS - 1>();
    __syncthreads();                       // tile i is in (and q)
    const bf16* tile = ring + (i % C::NS) * C::SK * ldk;
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < MAX_HEAD_DIM / 16; ++kk)
        if (kk * 16 < hd)
          ldsm_x4(qa[kk], Qs + (lane & 15) * ldk + kk * 16 +
                              ((lane >> 4) << 3));
    }
    if (i < nt) {
      // S (16 x 16 keys a warp) = q K^T over hd / 16 steps
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < MAX_HEAD_DIM / 16; ++kk) {
        if (kk * 16 >= hd) break;
        uint32_t bb[4];
        ldsm_x4(bb, tile + (16 * warp + (lane & 7) + ((lane >> 4) << 3)) *
                               ldk + kk * 16 + (((lane >> 3) & 1) << 3));
        mma_bf16(sc[0], qa[kk], bb[0], bb[1]);
        mma_bf16(sc[1], qa[kk], bb[2], bb[3]);
      }
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8)
#pragma unroll
        for (int nt8 = 0; nt8 < 2; ++nt8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int g = gr + 8 * h8;
            const int j = i * C::SK + 16 * warp + 8 * nt8 + 2 * (lane & 3) + e;
            if (g < G && j < n)
              Ls[g * chunk + j] =
                  ok_s[j] ? (CAP ? scaled2(sc[nt8][2 * h8 + e], ls)
                                 : sc[nt8][2 * h8 + e] * sl)
                          : NEG;
          }
      if (i == nt - 1) {
        __syncthreads();                   // every logit of the chunk
        for (int g = warp; g < G; g += C::WARPS) {   // a warp a head
          float* sr = Ls + g * chunk;
          float mx = -INFINITY;
          for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, sr[jj]);
#pragma unroll
          for (int o2 = 16; o2 > 0; o2 >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
          float sum = 0.f;
          for (int jj = lane; jj < n; jj += 32) {
            const float p = fast_exp2(sr[jj] - mx);
            sr[jj] = p;
            sum += p;
          }
#pragma unroll
          for (int o2 = 16; o2 > 0; o2 >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o2);
          if (lane == 0) {
            m_out[stat0 + g] = mx;
            l_out[stat0 + g] = sum;
          }
        }
      }
    } else {
      // O (16 x hd/4 columns a warp) += P V over the tile's 4 key steps
      const int j0 = (i - nt) * C::SK;
#pragma unroll
      for (int ks = 0; ks < C::SK / 16; ++ks) {
        float pv[2][4];
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = gr + 8 * h8;
            const int j = j0 + 16 * ks + 2 * (lane & 3) + (e & 1) +
                          8 * (e >> 1);
            pv[h8][e] = g < G && j < n ? Ls[g * chunk + j] : 0.f;
          }
        const uint32_t a[4] = {pack_bf16(pv[0][0], pv[0][1]),
                               pack_bf16(pv[1][0], pv[1][1]),
                               pack_bf16(pv[0][2], pv[0][3]),
                               pack_bf16(pv[1][2], pv[1][3])};
#pragma unroll
        for (int np = 0; np < MAX_HEAD_DIM / 64; ++np) {
          if (np * 64 >= hd) break;        // 16 columns a pair of n8 tiles
          uint32_t bb[4];
          ldsm_x4_t(bb, tile + (16 * ks + (lane & 7) +
                                (((lane >> 3) & 1) << 3)) * ldk +
                            cw + 16 * np + ((lane >> 4) << 3));
          mma_bf16(o[2 * np], a, bb[0], bb[1]);
          mma_bf16(o[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      if (i == total - 1) {
#pragma unroll
        for (int nd = 0; nd < MAX_HEAD_DIM / 32; ++nd) {
          if (nd * 8 >= hd / 4) break;
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const int g = gr + 8 * h8;
            if (g < G)
              *reinterpret_cast<float2*>(
                  acc_out + (stat0 + g) * hd + cw + 8 * nd +
                  2 * (lane & 3)) = make_float2(o[nd][2 * h8],
                                                o[nd][2 * h8 + 1]);
          }
        }
      }
    }
    __syncthreads();                       // the ring slot can be refilled
  }
  cp_wait<0>();
}

// Block (head h, batch b): merge the chunks of head h (m in base 2).
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ acc, float* __restrict__ out,
                      int H, int KV, int hd, int G, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / G, g = h - (h / G) * G;
  const long long base =
      (static_cast<long long>(b) * KV + kvh) * n_chunks * G + g;
  float mx = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, m[base + c * G]);
  float denom = 0.f;
  for (int c = 0; c < n_chunks; ++c)
    denom += fast_exp2(m[base + c * G] - mx) * l[base + c * G];
  const float inv = 1.f / fmaxf(denom, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float o = 0.f;
    for (int c = 0; c < n_chunks; ++c)
      o = fmaf(fast_exp2(m[base + c * G] - mx), acc[(base + c * G) * hd + d],
               o);
    out[(static_cast<long long>(b) * H + h) * hd + d] = o * inv;
  }
}

template <typename T, int GB, typename C, bool CAP>
cudaError_t decode_launch(const void* q, const void* k, const void* v,
                          const void* valid, int B, int Tk, int H, int KV,
                          int hd, int chunk, float scale, float softcap,
                          float* m, float* l, float* acc, float* out,
                          cudaStream_t stream) {
  using L = DecodeSmem<T, C>;
  const int G = H / KV;
  const int n_chunks = (Tk + chunk - 1) / chunk;
  const int smem = L::bytes(hd, G, chunk, GB);
  if (hd % L::VEC != 0 || smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T, GB, C, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T, GB, C, CAP><<<dim3(n_chunks, KV, B), C::NT, smem,
                                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid), Tk, H, KV,
      hd, G, chunk, n_chunks, scale, softcap, m, l, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<dim3(H, B), COMBINE_THREADS, 0, stream>>>(
      m, l, acc, out, H, KV, hd, G, n_chunks);
  return cudaGetLastError();
}

template <typename C, bool CAP>
cudaError_t decode_launch_tc(const void* q, const void* k, const void* v,
                             const void* valid, int B, int Tk, int H, int KV,
                             int hd, int chunk, float scale, float softcap,
                             float* m, float* l, float* acc, float* out,
                             cudaStream_t stream) {
  const int G = H / KV;
  const int n_chunks = (Tk + chunk - 1) / chunk;
  const int ldk = hd + 8;
  const int smem = 2 * (C::NS * C::SK + 16) * ldk + 4 * G * chunk + chunk;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel_tc<C, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_partial_kernel_tc<C, CAP><<<dim3(n_chunks, KV, B), C::NT, smem,
                                     stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(valid), Tk, H,
      KV, hd, G, chunk, n_chunks, scale, softcap, m, l, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<dim3(H, B), COMBINE_THREADS, 0, stream>>>(
      m, l, acc, out, H, KV, hd, G, n_chunks);
  return cudaGetLastError();
}

// The heads a pass over v: G rounded up to a power of two, at most
// DEC_GB (more heads take several passes).
template <typename T, typename C, bool CAP>
cudaError_t decode_dispatch(const void* q, const void* k, const void* v,
                            const void* valid, int B, int Tk, int H, int KV,
                            int hd, int chunk, float scale, float softcap,
                            float* m, float* l, float* acc, float* out,
                            cudaStream_t stream) {
  const int G = H / KV;
#define DECODE_CASE(GB)                                                    \
  if (G <= GB)                                                             \
    return decode_launch<T, GB, C, CAP>(q, k, v, valid, B, Tk, H, KV, hd,  \
                                   chunk, scale, softcap, m, l, acc, out,  \
                                   stream);
  DECODE_CASE(1)
  DECODE_CASE(2)
  DECODE_CASE(4)
#undef DECODE_CASE
  return decode_launch<T, DEC_GB, C, CAP>(q, k, v, valid, B, Tk, H, KV, hd,
                                          chunk, scale, softcap, m, l, acc,
                                          out, stream);
}

bool shapes_ok(int B, int H, int KV, int hd) {
  return B > 0 && KV > 0 && H % KV == 0 && hd > 0 && hd <= MAX_HEAD_DIM &&
         hd % 16 == 0;
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv) -> out (B, S, H,
// hdv), all of one type (dtype 0: float, 1: bf16), contiguous, head dims
// multiples of 16, at most 64 query heads a KV head.  lse, when not null,
// gets each row's base-2 log-sum-exp (B, S, H) f32: m + log2(l) over the
// logits x * log2(e) (a row with no valid key gets NEG + log2(T)); the
// store is a template flag, so a call without it runs the kernel as it
// was before the flag existed.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int dtype, int B, int S,
                           int Tk, int H, int KV, int hd, int hdv, int causal,
                           int window, float softcap, float scale,
                           void* stream) {
  if (!shapes_ok(B, H, KV, hd) || S <= 0 || Tk <= 0 || H / KV > MAX_GROUP ||
      hdv <= 0 || hdv > MAX_HEAD_DIM || hdv % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  const int dmax = hd > hdv ? hd : hdv;
#define FLASH_CASE(D)                                                       \
  if (dmax <= D) {                                                          \
    if (dtype == 0)                                                         \
      return flash_f32<D>(q, k, v, out, lf, B, S, Tk, H, KV, hd, hdv,       \
                          causal, window, softcap, scale, st);              \
    if (dtype == 1)                                                         \
      return flash_bf16<D>(q, k, v, out, lf, B, S, Tk, H, KV, hd, hdv,      \
                           causal, window, softcap, scale, st);             \
    return cudaErrorInvalidValue;                                           \
  }
  FLASH_CASE(64)
  FLASH_CASE(128)
  FLASH_CASE(256)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

// q (B, H, hd), k/v (B, T, KV, hd), valid (B, T) one byte each -> out
// (B, H, hd) f32, logits scaled by scale, then (softcap > 0) capped to
// softcap * tanh(logit / softcap), then masked; m/l (B, KV, chunks, G)
// and acc (B, KV, chunks, G, hd) f32 scratch, chunks = ceil(T / chunk).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, int dtype, int B, int Tk,
                            int H, int KV, int hd, int chunk, float scale,
                            float softcap, void* m, void* l, void* acc,
                            void* out, void* stream) {
  if (!shapes_ok(B, H, KV, hd) || Tk <= 0 || chunk <= 0 ||
      chunk > DEC_MAX_CHUNK || softcap < 0.f)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  float* of = static_cast<float*>(out);
  // the soft cap is a template flag, so the kernels without it compile
  // as they did before it existed (the cap's tanh costs registers)
#define DECODE_ARGS                                                         \
  q, k, v, valid, B, Tk, H, KV, hd, chunk, scale, softcap, mf, lf, af, of, st
  const bool cap = softcap > 0.f;
  if (dtype == 0)
    return cap ? decode_dispatch<float, DecCfg<256, 32, 3>, true>(DECODE_ARGS)
               : decode_dispatch<float, DecCfg<256, 32, 3>, false>(
                     DECODE_ARGS);
  if (dtype == 1 && H / KV <= 16 && hd % 64 == 0)
    return cap ? decode_launch_tc<DecCfg<128, 64, 3>, true>(DECODE_ARGS)
               : decode_launch_tc<DecCfg<128, 64, 3>, false>(DECODE_ARGS);
  if (dtype == 1)
    return cap ? decode_dispatch<bf16, DecCfg<128, 32, 3>, true>(DECODE_ARGS)
               : decode_dispatch<bf16, DecCfg<128, 32, 3>, false>(
                     DECODE_ARGS);
#undef DECODE_ARGS
  return cudaErrorInvalidValue;
}

// the most keys decode_attention_launch takes as one chunk
int decode_max_chunk(void) { return DEC_MAX_CHUNK; }

}  // extern "C"
