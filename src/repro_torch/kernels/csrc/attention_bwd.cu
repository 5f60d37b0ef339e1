// The backward of flash attention for Hopper (sm_90a): dQ, dK and dV of
// the forward in attention.cu (flash_kernel_f32<D>, flash_kernel_bf16<D>).
// The reference has no Pallas counterpart: it differentiates its jnp
// attention (_sdpa) with XLA's autodiff.  This is the port's own kernel,
// the backward of kernels/attention.py::FlashAttention.
//
// Semantics: those of the forward and of its plain version.  Logits are
// s = scale * q.k, capped to c * tanh(s / c) when softcap c > 0; a key is
// valid for query position i when j < T, j <= i (causal) and i - j <
// window (window > 0), where row r of q has position q_start + r (q_start
// > 0 for a context-parallel rank's block of rows against all T keys).  P = softmax over the valid keys; a row with no
// valid key (only possible with a window) has P = 1/T over all T keys
// (the forward's -2e38 masks make every logit equal), so each key's dV
// gets dO / T from it and no gradient flows to its q or to any k.  With
// D_i = rowsum(dO_i * O_i):
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . V_j - D_i) * (1 - tanh^2) * scale   (valid only)
//   dQ_i = sum_j dS_ij K_j,   dK_j = sum_i dS_ij Q_i
// GQA: query head h reads KV head h / G, so dK and dV sum over the G
// heads of the group.  P comes from the forward's log-sum-exp, kept by
// its epilogue in the base-2 domain it works in (lse2 = m + log2(l) over
// x = logit * log2(e)): P_ij = 2^(x_ij - lse2_i), with the forward's own
// LogitScale constants (flash_common.cuh).  A row with no valid key
// never reads its lse2 (the forward's value there is an NEG artefact).
//
// Bound: operations.  A backward recomputes S = Q K^T and does four more
// products (dP = dO V^T, dV += P^T dO, dQ += dS K, dK += dS^T Q): 2.5 times
// the forward's FLOPs, against 989 TFLOP/s (bf16) or 67 (f32).  Its
// inputs are read about once, so bytes bound it only at tiny shapes.
// Two kernels, no atomics, so gradients are the same bit for bit from
// run to run; 7 products in all (S and dP are recomputed by the second):
//   dQ kernel: a block holds the rows (query position, head) of the G
//     heads of one KV head for a run of positions, with their Q, dO, lse2
//     and D (which it computes from dO and O and writes for the second
//     kernel), walks the key tiles the masks leave and accumulates dQ.
//   dK/dV kernel: a block holds a tile of keys of one KV head with their
//     K and V, walks the query tiles of all G heads (those that see one
//     of its keys or hold a row with no key) and accumulates dK and dV,
//     so the sum over the group stays inside the block.
// Blocks start longest first (the key or query tile is the slowest grid
// dimension).  The masks are applied element by element from each row's
// valid range [lo, hi] (lo > hi: no valid key).
//
// bf16: both kernels on the tensor cores, wgmma.mma_async bf16 -> f32,
// with the forward's helpers.  Tiles are 64-row blocks stored in
// 64-column blocks with the 128-byte swizzle; tiles that stream are
// double-buffered and copied by 16-byte cp.async while the previous tile
// multiplies.  The elementwise steps run on the accumulator fragments,
// and P and dS become the A fragments of the next products in place
// (the forward's P trick) as bf16 pairs hi + lo (a_frags): rounded once,
// they miss the bf16 tolerance, so the three rs products run twice (10
// products in all, 7 in f32); every sum stays f32.
//   bwd_dq_bf16<D, NWG>: NWG warpgroups of 64 rows (2 up to D = 128, 1 at
//     256 for shared memory) share each K/V tile.  S = Q K^T and dP =
//     dO V^T are ss products (both K-major); dQ += dS K is an rs product
//     with K through the MN-major (transposed) descriptor, as O += P V
//     reads V in the forward.
//   bwd_dkdv_bf16<D, SPLIT>: the transposed formulation, one warpgroup a
//     64-key tile (a block 128 keys: 64 keys a block at the training shape,
//     128 blocks, ran no faster), sharing each 64-row Q/dO tile.  S^T = K Q^T
//     and dP^T = V dO^T (ss), P^T and dS^T in registers with each query
//     column's lse2, D and range from shared memory, dV += P^T dO and dK +=
//     dS^T Q (rs, dO and Q MN-major).  A thread holds dK 64, dV 64, S^T 32 and
//     dP^T 32 f32 at D <= 128.  At D = 256 dK and dV alone would take 256
//     registers, so (SPLIT) the two warpgroups of a block share one 64-key
//     tile and split the columns of dK and dV: each computes the whole S^T and
//     dP^T itself (the two products once more rather than P^T and dS^T passed
//     through shared memory, which the 192 KB of tiles at D = 256 leave no
//     room to double-buffer) and the half of dK and dV it owns.
// f32: full f32 on the CUDA cores (TF32 would not hold the f32
// tolerances, the choice the f32 forward made), register-tiled like an
// SGEMM against shared-memory bandwidth: a thread owns 4 x 4 (dQ kernel)
// or 4 x BM/8 (dK/dV) of each score tile and 8 rows (keys) x D/16
// columns of its accumulator, and reads its operands by 16-byte shared
// loads from rows padded so that those loads are free of bank conflicts
// (a warp's score loads take one wavefront each: 8 FMAs a wavefront,
// where 8 x 2 tiles gave 5.3 and a dQ kernel 15 % slower);
// P and dS go through shared memory laid out so that the operand of each
// reduction step is contiguous (dS [key][row] for dQ += dS K, P and dS
// [row][key] for dV += P^T dO and dK += dS^T Q).
//   bwd_dq_f32<D>: 128 rows (64 above D = 128) a block, 2 threads a row,
//     key tiles of 32.  One K and one V buffer, their copies offset by
//     half a tile (V of tile t + 1 lands during S and dQ of tile t, K of
//     tile t + 1 during dP of t + 1).
//   bwd_dkdv_f32<D, KB>: KB = 64 keys a block (32 at D = 256, or when
//     there would be fewer than two blocks an SM: the training shape's
//     T = 128 gives 256 blocks, two an SM, and runs a few % faster than
//     with 64; tools/torch_bwd_tiles.py), query tiles of 32 rows (64 at
//     D = 64) double-buffered.  The block's two halves split the work
//     without splitting a tile: half A computes S^T, P^T and P^T *
//     d(logit) and accumulates dV; half B computes dP^T, then dS^T from
//     half A's numbers, and accumulates dK.
// Head dims are compile-time ceilings D in {64, 128, 256}, and 192 in
// f32 (MLA's hd 192: its smaller tiles let the dK/dV kernel take 64 keys
// with 8 warps an SM where D = 256 fits 32 keys and 4 warps); the copies
// zero-fill the columns past hd (hdv) and the loops stop at them.  The
// wrapper pads head dims to a multiple of 16.  Plain C interface (loaded
// with ctypes); the launcher returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take) and launches on the
// caller's stream.  TMA, warp specialisation and 3xTF32 are later work.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int MAX_HEAD_DIM = 256;
constexpr int MAX_GROUP = 64;

// The geometry of one call.
struct Geo {
  int S, Tk, H, KV, G, hd, hdv, causal, window;
  float scale, inv_t;                 // 1 / T: P of a row with no key
  LogitScale ls;
  int q_start;                        // the masks' position of query row 0
  // the valid keys of query row i (position q_start + i) are [lo(i),
  // hi(i)]; none if lo > hi
  __device__ __forceinline__ int lo(int i) const {
    return window > 0 ? max(0, q_start + i - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int i) const {
    return causal ? min(q_start + i, Tk - 1) : Tk - 1;
  }
  // (b, position, head) row of flattened row R = position * G + head
  __device__ __forceinline__ long long row(int b, int kvh, int R) const {
    const int pos = R / G;
    return (static_cast<long long>(b) * S + pos) * H + kvh * G + R - pos * G;
  }
};

// The base-2 logit x of a raw product s, and d(logit)/ds: the scale,
// times 1 - tanh^2 under the soft cap.
__device__ __forceinline__ float logit_d(float s, const Geo& g, float* dl) {
  if (g.ls.cap > 0.f) {
    const float th = tanhf(s * g.ls.inv);
    *dl = (1.f - th * th) * g.scale;
    return g.ls.cap * th;
  }
  *dl = g.scale;
  return s * g.ls.mul;
}

// 4 bytes global -> shared (zero-filled when full == false).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// Tile rows [0, BM) <- flattened rows r0 + r of KV head kvh (row R is
// (position R / G, head kvh * G + R % G)); `width` real columns of D.
template <typename T, int D, int BM, int NT, typename Dst>
__device__ __forceinline__ void load_rows(const T* src, int b, const Geo& g,
                                          int kvh, int width, int r0,
                                          int rows, Dst dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int e = threadIdx.x; e < BM * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < rows && c * VEC < width;
    const T* s = ok ? src + g.row(b, kvh, r0 + r) * width + c * VEC : src;
    cp_async16(dst(r, c), s, ok);
  }
}

// A query tile's row data for the dK/dV kernels, 4 x BM words: the
// forward's lse2 and D (cp.async, zero past the rows), then lo and hi
// (a row past the end gets lo > hi: its dO and Q are zero-filled, so the
// 1/T it is given moves nothing).
template <int BM, int NT>
__device__ __forceinline__ void load_row_info(float* ri, const float* lse,
                                              const float* dvec, int b,
                                              const Geo& g, int kvh, int r0,
                                              int rows) {
  int* rl = reinterpret_cast<int*>(ri);
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int R = r0 + r;
    const bool ok = R < rows;
    const long long i = ok ? g.row(b, kvh, R) : 0;
    cp_async4(ri + r, lse + i, ok);
    cp_async4(ri + BM + r, dvec + i, ok);
    const int pos = R / g.G;
    rl[2 * BM + r] = ok ? g.lo(pos) : 1;
    rl[3 * BM + r] = ok ? g.hi(pos) : 0;
  }
}

// Whether query tile [r0, r0 + BM) reaches keys [k0, ke] of the block:
// some row sees one of them, or some row has no key (the last row
// decides: both ends of the range are nondecreasing in the position).
__device__ __forceinline__ bool tile_needed(const Geo& g, int r0, int BM,
                                            int rows, int k0, int ke) {
  const int p0 = r0 / g.G, p1 = (min(r0 + BM, rows) - 1) / g.G;
  if (g.lo(p1) > g.hi(p1)) return true;
  return g.lo(p0) <= ke && g.hi(p1) >= k0;
}

__device__ __forceinline__ float dot8(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 w =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

// ------------------------------------------------------ bf16, wgmma

// The k16 A fragment kk of an accumulator tile as a pair of bf16
// fragments, hi = bf16(x) and lo = bf16(x - hi): hi + lo holds x to about
// 2^-17, where hi alone (2^-9) breaks the bf16 tolerance of dQ and dK (dS
// sums to zero over a row, so its rounding errors do not cancel) and of
// dV.  B (K, Q, dO) is bf16 already, so two products give the f32 result.
__device__ __forceinline__ void a_frags(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&x)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(a - hf.x, b - hf.y);
  }
}

// A descriptor the compiler computes where it is used: without this it
// hoists every k-step's descriptor of a loop-invariant tile out of the
// tile loop, two registers each.
__device__ __forceinline__ uint64_t here(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// Descriptors of a 64-row tile: kmajor(tile) for a product's K-major A
// or B operand, mnmajor(tile) for its MN-major B operand (the tile's rows
// the reduction); step(d, kk) moves either to the k16 step kk.
__device__ __forceinline__ uint64_t kmajor(const bf16* tile) {
  return here(gmma_desc(tile, 16, 1024));
}
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile) {
  return here(gmma_desc(tile, 64 * 128, 1024));
}
// the start address field counts 16 bytes: a K-major k16 step is 32
// bytes within a 128-byte row, then the next 64-column block (8 KB)
__device__ __forceinline__ uint64_t kstep(uint64_t d, int kk) {
  return d + (((kk >> 2) * 8192 + (kk & 3) * 32) >> 4);
}
// an MN-major k16 step is 16 rows of 128 bytes
__device__ __forceinline__ uint64_t mnstep(uint64_t d, int kk) {
  return d + ((kk * 16 * 128) >> 4);
}

// Aligned start of the dynamic shared memory (the swizzle needs 1024).
__device__ __forceinline__ bf16* smem_1024(unsigned char* p) {
  return reinterpret_cast<bf16*>(p + ((1024 - (smem_u32(p) & 1023)) & 1023));
}

template <int D, int NWG> struct DqBf16 {
  static constexpr int NT = 128 * NWG, BM = 64 * NWG;
  static constexpr int SMEM = static_cast<int>(sizeof(bf16)) *
                                  (2 * BM * D + 4 * 64 * D) +
                              8 * BM + 1024;
};

// Warpgroup w owns block rows 64w..64w+63; lane l of its warp v holds rows
// 64w + 16v + l/4 (+ 8), key columns 8nt + 2(l%4) + {0, 1} of S and dP,
// value columns 8nd + 2(l%4) + {0, 1} of dQ.
template <int D, int NWG>
__global__ void __launch_bounds__(DqBf16<D, NWG>::NT, 1)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            bf16* __restrict__ dq, float* __restrict__ dvec, Geo g, int bq,
            int n_qt) {
  using C = DqBf16<D, NWG>;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  bf16* Qs = smem_1024(dq_smem);
  bf16* dOs = Qs + C::BM * D;
  bf16* Kbuf = dOs + C::BM * D;
  bf16* Vbuf = Kbuf + 2 * 64 * D;
  float* sL = reinterpret_cast<float*>(Vbuf + 2 * 64 * D);
  float* sD = sL + C::BM;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_qt - 1 - blockIdx.z) * bq;
  const int rows = bq * g.G;
  const int q_last = min(q0 + bq, g.S) - 1;
  const int klo = g.lo(q0), khi = g.hi(q_last);
  const int t_begin = klo / 64, t_end = klo <= khi ? khi / 64 : t_begin - 1;

  auto kslot = [&](int t) { return Kbuf + (t & 1) * 64 * D; };
  auto vslot = [&](int t) { return Vbuf + (t & 1) * 64 * D; };
  auto load_tile = [&](int t) {
    bf16* kb = kslot(t);
    bf16* vb = vslot(t);
    load_kv<bf16, D, C::NT>(k, b, g.Tk, g.KV, kvh, g.hd, t * 64,
                            [&](int r, int c) { return sw128(kb, r, c); });
    load_kv<bf16, D, C::NT>(v, b, g.Tk, g.KV, kvh, g.hdv, t * 64,
                            [&](int r, int c) { return sw128(vb, r, c); });
  };
  auto rows_at = [&](bf16* base) {
    return [=](int r, int c) { return sw128(base + (r >> 6) * 64 * D,
                                            r & 63, c); };
  };
  load_q<bf16, D, C::BM, C::NT>(q, b, g.S, g.H, kvh, g.G, g.hd, q0, rows,
                                rows_at(Qs));
  load_q<bf16, D, C::BM, C::NT>(dout, b, g.S, g.H, kvh, g.G, g.hdv, q0,
                                rows, rows_at(dOs));
  load_tile(t_begin);
  cp_commit();

  // D = rowsum(dO * O) (written for the dK/dV kernel) and the forward's
  // lse2, 8 lanes a row
  for (int e = tid; e < C::BM * 8; e += C::NT) {
    const int r = e >> 3, part = e & 7;
    const int qp = q0 + r / g.G;
    const bool ok = r < rows && qp < g.S;
    const long long i = (static_cast<long long>(b) * g.S + qp) * g.H +
                        kvh * g.G + r % g.G;
    float acc = 0.f;
    if (ok)
      for (int c = 8 * part; c < g.hdv; c += 64)
        acc += dot8(dout + i * g.hdv + c, o + i * g.hdv + c);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (part == 0) {
      sD[r] = acc;
      sL[r] = ok ? lse[i] : 0.f;
      if (ok) dvec[i] = acc;
    }
  }
  __syncthreads();
  float rl[2], rd[2];
  int rlo[2], rhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
    const int qp = q0 + r / g.G;
    const bool ok = r < rows && qp < g.S;
    rl[i] = sL[r];
    rd[i] = sD[r];
    rlo[i] = ok ? g.lo(qp) : 1;
    rhi[i] = ok ? g.hi(qp) : 0;
  }

  const bf16* Qw = Qs + wg * 64 * D;
  const bf16* dOw = dOs + wg * 64 * D;
  float dqa[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dqa[e] = 0.f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * 64;
    if (t < t_end) load_tile(t + 1);       // rides along tile t
    cp_commit();
    cp_wait<1>();
    fence_async_shared();                  // the copies, seen by wgmma
    __syncthreads();                       // Q, dO, K and V of tile t are in
    const bf16* Ks = kslot(t);
    const bf16* Vs = vslot(t);

    float s[32] = {}, dp[32] = {};
    wg_arrive();
    {
      const uint64_t dq_ = kmajor(Qw), dk_ = kmajor(Ks);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk * 16 >= g.hd) break;        // zero columns: no product
        wgmma_ss_n64(s, kstep(dq_, kk), kstep(dk_, kk), kk > 0);
      }
    }
    {
      const uint64_t do_ = kmajor(dOw), dv_ = kmajor(Vs);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk * 16 >= g.hdv) break;
        wgmma_ss_n64(dp, kstep(do_, kk), kstep(dv_, kk), kk > 0);
      }
    }
    wg_commit();
    wg_wait<0>();

    // dS in the dP fragments: P from the forward's lse2, the masks from
    // each row's valid range
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * nt + 2 * i + e;
          const int kj = k0 + 8 * nt + 2 * (lane & 3) + e;
          float ds = 0.f;
          if (kj >= rlo[i] && kj <= rhi[i]) {
            float dl;
            const float lg = logit_d(s[x], g, &dl);
            ds = fast_exp2(lg - rl[i]) * (dp[x] - rd[i]) * dl;
          }
          dp[x] = ds;
        }

    // dQ += dS K: dS as a bf16 pair in registers, K MN-major
    wg_arrive();
    {
      const uint64_t dk_ = mnmajor(Ks);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        a_frags(hi, lo, dp, kk);
        PV<D>::mma(dqa, hi, mnstep(dk_, kk));
        PV<D>::mma(dqa, lo, mnstep(dk_, kk));
      }
    }
    wg_commit();
    wg_wait<0>();
    __syncthreads();                       // both buffers of tile t free
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
    const int qp = q0 + r / g.G;
    if (r >= rows || qp >= g.S) continue;
    bf16* dst = dq + ((static_cast<long long>(b) * g.S + qp) * g.H +
                      kvh * g.G + r % g.G) * g.hd;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = 8 * nd + 2 * (lane & 3);
      if (c < g.hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
            dqa[4 * nd + 2 * i], dqa[4 * nd + 2 * i + 1]);
    }
  }
}

template <int D, bool SPLIT> struct DkvBf16 {
  static constexpr int NT = 256;                     // two warpgroups
  static constexpr int KB = SPLIT ? 64 : 128;        // keys a block
  static constexpr int NC = SPLIT ? D / 2 : D;       // dK, dV columns a wg
  static constexpr int SMEM = static_cast<int>(sizeof(bf16)) *
                                  (2 * KB * D + 4 * 64 * D) +
                              4 * 2 * 4 * 64 + 1024;
};

// Warpgroup w owns keys kw..kw+63 of the block (kw = 64w, or 0 when
// SPLIT) and dK/dV columns from 128cb (cb = w when SPLIT, else 0); lane l
// of its warp v holds keys kw + 16v + l/4 (+ 8), query columns 8nt +
// 2(l%4) + {0, 1} of S^T and dP^T, and columns 8nd + 2(l%4) + {0, 1} of
// its dK and dV.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(DkvBf16<D, SPLIT>::NT, 1)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              bf16* __restrict__ dk, bf16* __restrict__ dv, Geo g) {
  using C = DkvBf16<D, SPLIT>;
  constexpr int NC = C::NC;
  extern __shared__ __align__(1024) unsigned char kv_smem[];
  bf16* Ks = smem_1024(kv_smem);
  bf16* Vs = Ks + C::KB * D;
  bf16* Qb = Vs + C::KB * D;               // 2 buffers of 64 rows
  bf16* Ob = Qb + 2 * 64 * D;
  float* Rb = reinterpret_cast<float*>(Ob + 2 * 64 * D);   // 2 x 4 x 64

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::KB, ke = min(k0 + C::KB, g.Tk) - 1;
  const int kw = SPLIT ? 0 : 64 * wg, cb = SPLIT ? wg * NC / 64 : 0;
  const int rows = g.S * g.G, n_rt = (rows + 63) / 64;

#pragma unroll
  for (int h = 0; h < C::KB / 64; ++h) {
    bf16* kb = Ks + h * 64 * D;
    bf16* vb = Vs + h * 64 * D;
    load_kv<bf16, D, C::NT>(k, b, g.Tk, g.KV, kvh, g.hd, k0 + 64 * h,
                            [&](int r, int c) { return sw128(kb, r, c); });
    load_kv<bf16, D, C::NT>(v, b, g.Tk, g.KV, kvh, g.hdv, k0 + 64 * h,
                            [&](int r, int c) { return sw128(vb, r, c); });
  }
  auto next = [&](int rt) {
    do ++rt;
    while (rt < n_rt && !tile_needed(g, rt * 64, 64, rows, k0, ke));
    return rt;
  };
  auto load_tile = [&](int rt, int buf) {
    bf16* qb = Qb + buf * 64 * D;
    bf16* ob = Ob + buf * 64 * D;
    load_rows<bf16, D, 64, C::NT>(q, b, g, kvh, g.hd, rt * 64, rows,
                                  [&](int r, int c) {
                                    return sw128(qb, r, c);
                                  });
    load_rows<bf16, D, 64, C::NT>(dout, b, g, kvh, g.hdv, rt * 64, rows,
                                  [&](int r, int c) {
                                    return sw128(ob, r, c);
                                  });
    load_row_info<64, C::NT>(Rb + buf * 256, lse, dvec, b, g, kvh, rt * 64,
                             rows);
  };

  float dka[NC / 2], dva[NC / 2];
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) dka[e] = dva[e] = 0.f;
  const bool do_dk = 64 * cb < g.hd, do_dv = 64 * cb < g.hdv;
  const bf16* Kw = Ks + kw * D;
  const bf16* Vw = Vs + kw * D;

  int rt = tile_needed(g, 0, 64, rows, k0, ke) ? 0 : next(0);
  if (rt < n_rt) load_tile(rt, 0);
  cp_commit();                             // K, V and the first tile
  for (int buf = 0; rt < n_rt; buf ^= 1) {
    const int nx = next(rt);
    if (nx < n_rt) load_tile(nx, buf ^ 1);   // rides along tile rt
    cp_commit();
    cp_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bf16* Qs = Qb + buf * 64 * D;
    const bf16* dOs = Ob + buf * 64 * D;
    const float* ri = Rb + buf * 256;
    const int* rn = reinterpret_cast<const int*>(ri);

    float st[32] = {}, dpt[32] = {};
    wg_arrive();
    {
      const uint64_t dk_ = kmajor(Kw), dq_ = kmajor(Qs);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk * 16 >= g.hd) break;
        wgmma_ss_n64(st, kstep(dk_, kk), kstep(dq_, kk), kk > 0);
      }
    }
    {
      const uint64_t dv_ = kmajor(Vw), do_ = kmajor(dOs);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk * 16 >= g.hdv) break;
        wgmma_ss_n64(dpt, kstep(dv_, kk), kstep(do_, kk), kk > 0);
      }
    }
    wg_commit();
    wg_wait<0>();

    // P^T in the S^T fragments, dS^T in the dP^T ones
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * (lane & 3);
      const float2 L = *reinterpret_cast<const float2*>(ri + c);
      const float2 Dv = *reinterpret_cast<const float2*>(ri + 64 + c);
      const int2 lo = *reinterpret_cast<const int2*>(rn + 128 + c);
      const int2 hi = *reinterpret_cast<const int2*>(rn + 192 + c);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = k0 + kw + 16 * warp + (lane >> 2) + 8 * i;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * nt + 2 * i + e;
          const int l_ = e ? lo.y : lo.x, h_ = e ? hi.y : hi.x;
          float p = 0.f, ds = 0.f;
          if (l_ > h_) {
            p = g.inv_t;
          } else if (kj >= l_ && kj <= h_) {
            float dl;
            const float lg = logit_d(st[x], g, &dl);
            p = fast_exp2(lg - (e ? L.y : L.x));
            ds = p * (dpt[x] - (e ? Dv.y : Dv.x)) * dl;
          }
          st[x] = p;
          dpt[x] = ds;
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q: A a bf16 pair from registers, dO and Q
    // MN-major from column block cb; the dK group waits for the dV group
    // (both in flight at once pin 64 registers of A fragments and ran
    // slower)
    if (do_dv) {
      wg_arrive();
      const uint64_t do_ = mnmajor(dOs + cb * 64 * 64);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        a_frags(hi, lo, st, kk);
        PV<NC>::mma(dva, hi, mnstep(do_, kk));
        PV<NC>::mma(dva, lo, mnstep(do_, kk));
      }
      wg_commit();
      wg_wait<0>();
    }
    if (do_dk) {
      wg_arrive();
      const uint64_t dq_ = mnmajor(Qs + cb * 64 * 64);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        a_frags(hi, lo, dpt, kk);
        PV<NC>::mma(dka, hi, mnstep(dq_, kk));
        PV<NC>::mma(dka, lo, mnstep(dq_, kk));
      }
      wg_commit();
      wg_wait<0>();
    }
    __syncthreads();                       // buffer buf free
    rt = nx;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + kw + 16 * warp + (lane >> 2) + 8 * i;
    if (kj >= g.Tk) continue;
    const long long base = (static_cast<long long>(b) * g.Tk + kj) * g.KV +
                           kvh;
#pragma unroll
    for (int nd = 0; nd < NC / 8; ++nd) {
      const int c = 64 * cb + 8 * nd + 2 * (lane & 3);
      if (c < g.hd)
        *reinterpret_cast<__nv_bfloat162*>(dk + base * g.hd + c) =
            __floats2bfloat162_rn(dka[4 * nd + 2 * i],
                                  dka[4 * nd + 2 * i + 1]);
      if (c < g.hdv)
        *reinterpret_cast<__nv_bfloat162*>(dv + base * g.hdv + c) =
            __floats2bfloat162_rn(dva[4 * nd + 2 * i],
                                  dva[4 * nd + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------- f32, CUDA cores

// Row r of a tile whose warps read rows 4 apart at once, padded by 4
// floats every 4 rows so that those reads fall in different banks.
template <int D> __device__ __forceinline__ int row4(int r) {
  return r * D + (r >> 2) * 4;
}

// s[i][j] = sum over d < n of A[row4(4pr + i)][d] * B[(pk + 8j) * LDB + d]:
// 4 rows x 4 keys a thread, 16-byte loads.
template <int D, int LDB>
__device__ __forceinline__ void rows_keys(float (&s)[4][4], const float* a,
                                          const float* bm, int n, int pr,
                                          int pk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < n; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + row4<D>(4 * pr + i) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(bm + (pk + 8 * j) * LDB + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = fmaf(x[i].x, y[j].x, fmaf(x[i].y, y[j].y, fmaf(
            x[i].z, y[j].z, fmaf(x[i].w, y[j].w, s[i][j]))));
  }
}

template <int D> struct DqF32 {
  static constexpr int BM = D <= 128 ? 128 : 64;    // rows a block
  static constexpr int NT = 2 * BM;                 // threads
  static constexpr int KT = 32;                     // keys a tile
  static constexpr int LDK = D + 4;                 // K/V row stride
  static constexpr int LDS = BM + 4;                // dS [key][row] stride
  static constexpr int QF = BM * D + BM;            // Q, dO floats (row4)
  static constexpr int SMEM = static_cast<int>(sizeof(float)) *
                              (2 * QF + 2 * KT * LDK + KT * LDS + 4 * BM);
};

// In S and dP thread (pr, pk) = (tid / 8, tid % 8) owns rows 4pr + i and
// keys pk + 8j (i, j < 4): a warp's 16-byte loads then touch 4 rows of Q
// or dO and 8 of K or V, one wavefront each.  In dQ thread (rg, kg) =
// (tid / 16, tid % 16) owns rows 8rg + i (i < 8), columns 4kg + 64jj + e.
template <int D>
__global__ void __launch_bounds__(DqF32<D>::NT)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ dq, float* __restrict__ dvec, Geo g, int bq,
           int n_qt) {
  using C = DqF32<D>;
  constexpr int KT = C::KT, LDK = C::LDK, LDS = C::LDS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::QF;
  float* Ks = dOs + C::QF;
  float* Vs = Ks + KT * LDK;
  float* Ss = Vs + KT * LDK;
  float* sL = Ss + KT * LDS;
  float* sD = sL + C::BM;
  int* sLo = reinterpret_cast<int*>(sD + C::BM);
  int* sHi = sLo + C::BM;

  const int tid = threadIdx.x, rg = tid >> 4, kg = tid & 15;
  const int pr = tid >> 3, pk = tid & 7;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_qt - 1 - blockIdx.z) * bq;
  const int rows = bq * g.G;
  const int q_last = min(q0 + bq, g.S) - 1;
  const int klo = g.lo(q0), khi = g.hi(q_last);
  const int t_begin = klo / KT, t_end = klo <= khi ? khi / KT : t_begin - 1;

  auto kdst = [&](int r, int c) { return Ks + r * LDK + 4 * c; };
  auto vdst = [&](int r, int c) { return Vs + r * LDK + 4 * c; };
  load_q<float, D, C::BM, C::NT>(
      q, b, g.S, g.H, kvh, g.G, g.hd, q0, rows,
      [&](int r, int c) { return Qs + row4<D>(r) + 4 * c; });
  load_q<float, D, C::BM, C::NT>(
      dout, b, g.S, g.H, kvh, g.G, g.hdv, q0, rows,
      [&](int r, int c) { return dOs + row4<D>(r) + 4 * c; });
  load_kv<float, D, C::NT, KT>(v, b, g.Tk, g.KV, kvh, g.hdv, t_begin * KT,
                               vdst);
  cp_commit();
  load_kv<float, D, C::NT, KT>(k, b, g.Tk, g.KV, kvh, g.hd, t_begin * KT,
                               kdst);
  cp_commit();

  // D = rowsum(dO * O) over the half-warp of a row, the forward's lse2,
  // and each row's valid range
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * rg + i;
    const int qp = q0 + r / g.G;
    const bool ok = r < rows && qp < g.S;
    const long long row = (static_cast<long long>(b) * g.S + qp) * g.H +
                          kvh * g.G + r % g.G;
    float acc = 0.f;
    if (ok) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const int c = 4 * kg + 64 * jj;
        if (c < g.hdv) {
          const float4 x =
              *reinterpret_cast<const float4*>(dout + row * g.hdv + c);
          const float4 y = *reinterpret_cast<const float4*>(o + row * g.hdv
                                                            + c);
          acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        }
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (kg == 0) {
      sD[r] = acc;
      sL[r] = ok ? lse[row] : 0.f;
      sLo[r] = ok ? g.lo(qp) : 1;
      sHi[r] = ok ? g.hi(qp) : 0;
      if (ok) dvec[row] = acc;
    }
  }

  float acc[8][D / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * KT;
    cp_wait<1>();
    __syncthreads();                       // V of tile t is in

    float dp[4][4];
    rows_keys<D, LDK>(dp, dOs, Vs, g.hdv, pr, pk);
    __syncthreads();                       // every warp is done with V
    if (t < t_end) load_kv<float, D, C::NT, KT>(v, b, g.Tk, g.KV, kvh, g.hdv,
                                                k0 + KT, vdst);
    cp_commit();
    cp_wait<1>();
    __syncthreads();                       // K of tile t is in

    float s[4][4];
    rows_keys<D, LDK>(s, Qs, Ks, g.hd, pr, pk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * pr + i;
      const int lo = sLo[r], hi = sHi[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + pk + 8 * j;
        float ds = 0.f;
        if (kj >= lo && kj <= hi) {
          float dl;
          const float lg = logit_d(s[i][j], g, &dl);
          ds = fast_exp2(lg - sL[r]) * (dp[i][j] - sD[r]) * dl;
        }
        s[i][j] = ds;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ss + (pk + 8 * j) * LDS + 4 * pr) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();                       // dS written

    // dQ += dS K: a row's 8 dS of key kk and 4 columns of K's row kk
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(Ss + kk * LDS +
                                                         8 * rg);
      const float4 p1 = *reinterpret_cast<const float4*>(Ss + kk * LDS +
                                                         8 * rg + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        if (64 * jj >= g.hd) break;
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + kk * LDK + 4 * kg + 64 * jj);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * jj] = fmaf(p[i], kv.x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(p[i], kv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i], kv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i], kv.w, acc[i][4 * jj + 3]);
        }
      }
    }
    __syncthreads();                       // every warp is done with K, dS
    if (t < t_end) load_kv<float, D, C::NT, KT>(k, b, g.Tk, g.KV, kvh, g.hd,
                                                k0 + KT, kdst);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * rg + i;
    const int qp = q0 + r / g.G;
    if (r >= rows || qp >= g.S) continue;
    float* dst = dq + ((static_cast<long long>(b) * g.S + qp) * g.H +
                       kvh * g.G + r % g.G) * g.hd;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const int c = 4 * kg + 64 * jj;
      if (c < g.hd)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                        acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    }
  }
}

template <int D, int KB> struct DkvF32 {
  static constexpr int BM = D <= 64 ? 64 : 32;      // query rows a tile
  static constexpr int NH = KB / 8 * 16;            // threads a half
  static constexpr int NT = 2 * NH;
  static constexpr int KF = KB * D + KB;            // K, V floats (row4)
  static constexpr int LDQ = D + 4;                 // Q, dO row stride
  static constexpr int LDS = KB + 4;                // P, dS [row][key]
  static constexpr int SMEM = static_cast<int>(sizeof(float)) *
                              (2 * KF + 4 * BM * LDQ + 2 * BM * LDS +
                               2 * 4 * BM);
};

// Half h = tid / NH of the block; its thread t = tid % NH: in S^T (half
// 0) or dP^T (half 1) (pa, pb) = (t / 8, t % 8) owns keys 4pa + i (i < 4)
// and query rows pb + 8j (j < BM / 8), so a warp's 16-byte loads touch 4
// rows of K or V and 8 of Q or dO, one wavefront each; in dV (half 0) or
// dK (half 1) (kg, cg) = (t / 16, t % 16) owns keys 8kg + i (i < 8) and
// columns 4cg + 64jj + e.
template <int D, int KB>
__global__ void __launch_bounds__(DkvF32<D, KB>::NT)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dvec,
             float* __restrict__ dk, float* __restrict__ dv, Geo g) {
  using C = DkvF32<D, KB>;
  constexpr int BM = C::BM, LDQ = C::LDQ, LDS = C::LDS, NJ = BM / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::KF;
  float* Qb = Vs + C::KF;                  // 2 buffers of BM rows
  float* Ob = Qb + 2 * BM * LDQ;
  float* Ps = Ob + 2 * BM * LDQ;           // P [row][key]
  float* Ds = Ps + BM * LDS;               // P * d(logit), then dS
  float* Rb = Ds + BM * LDS;               // 2 x 4 x BM row data

  const int tid = threadIdx.x, half = tid / C::NH, t = tid % C::NH;
  const int kg = t >> 4, cg = t & 15, pa = t >> 3, pb = t & 7;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * KB, ke = min(k0 + KB, g.Tk) - 1;
  const int rows = g.S * g.G, n_rt = (rows + BM - 1) / BM;

  load_kv<float, D, C::NT, KB>(
      k, b, g.Tk, g.KV, kvh, g.hd, k0,
      [&](int r, int c) { return Ks + row4<D>(r) + 4 * c; });
  load_kv<float, D, C::NT, KB>(
      v, b, g.Tk, g.KV, kvh, g.hdv, k0,
      [&](int r, int c) { return Vs + row4<D>(r) + 4 * c; });
  auto next = [&](int rt) {
    do ++rt;
    while (rt < n_rt && !tile_needed(g, rt * BM, BM, rows, k0, ke));
    return rt;
  };
  auto load_tile = [&](int rt, int buf) {
    float* qb = Qb + buf * BM * LDQ;
    float* ob = Ob + buf * BM * LDQ;
    load_rows<float, D, BM, C::NT>(
        q, b, g, kvh, g.hd, rt * BM, rows,
        [&](int r, int c) { return qb + r * LDQ + 4 * c; });
    load_rows<float, D, BM, C::NT>(
        dout, b, g, kvh, g.hdv, rt * BM, rows,
        [&](int r, int c) { return ob + r * LDQ + 4 * c; });
    load_row_info<BM, C::NT>(Rb + buf * 4 * BM, lse, dvec, b, g, kvh,
                             rt * BM, rows);
  };

  // half 0: S^T x K, P^T dO into dV; half 1: dP^T x V, dS^T Q into dK
  const float* X = half ? Vs : Ks;
  const int width_s = half ? g.hdv : g.hd;   // the score product's depth
  const int width_a = half ? g.hd : g.hdv;   // the accumulator's columns
  float acc[8][D / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  int rt = tile_needed(g, 0, BM, rows, k0, ke) ? 0 : next(0);
  if (rt < n_rt) load_tile(rt, 0);
  cp_commit();                             // K, V and the first tile
  for (int buf = 0; rt < n_rt; buf ^= 1) {
    const int nx = next(rt);
    if (nx < n_rt) load_tile(nx, buf ^ 1);   // rides along tile rt
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Qs = Qb + buf * BM * LDQ;
    const float* dOs = Ob + buf * BM * LDQ;
    const float* ri = Rb + buf * 4 * BM;
    const int* rn = reinterpret_cast<const int*>(ri);
    const float* Y = half ? dOs : Qs;

    // S^T = K Q^T (half 0) or dP^T = V dO^T (half 1), keys x rows
    float s[4][NJ] = {};
#pragma unroll 4
    for (int d = 0; d < width_s; d += 4) {
      float4 x[4], y[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = *reinterpret_cast<const float4*>(X + row4<D>(4 * pa + i) + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        y[j] = *reinterpret_cast<const float4*>(Y + (pb + 8 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          s[i][j] = fmaf(x[i].x, y[j].x, fmaf(x[i].y, y[j].y, fmaf(
              x[i].z, y[j].z, fmaf(x[i].w, y[j].w, s[i][j]))));
    }
    if (half == 0) {                       // P^T and P^T * d(logit)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = pb + 8 * j;
        const int lo = rn[2 * BM + c], hi = rn[3 * BM + c];
        const float L = ri[c];
        float p[4], pd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + 4 * pa + i;
          p[i] = pd[i] = 0.f;
          if (lo > hi) {
            p[i] = g.inv_t;
          } else if (kj >= lo && kj <= hi) {
            float dl;
            const float lg = logit_d(s[i][j], g, &dl);
            p[i] = fast_exp2(lg - L);
            pd[i] = p[i] * dl;
          }
        }
        *reinterpret_cast<float4*>(Ps + c * LDS + 4 * pa) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(Ds + c * LDS + 4 * pa) =
            make_float4(pd[0], pd[1], pd[2], pd[3]);
      }
    }
    __syncthreads();                       // P and P * d(logit) written
    if (half == 1) {                       // dS^T = P d(logit) (dP - D)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = pb + 8 * j;
        const float Dv = ri[BM + c];
        float4* w = reinterpret_cast<float4*>(Ds + c * LDS + 4 * pa);
        float4 x = *w;
        x.x *= s[0][j] - Dv;
        x.y *= s[1][j] - Dv;
        x.z *= s[2][j] - Dv;
        x.w *= s[3][j] - Dv;
        *w = x;
      }
    }
    __syncthreads();                       // dS written

    // dV += P^T dO (half 0), dK += dS^T Q (half 1): per row, 8 keys of
    // P or dS and 4 columns of dO or Q
    const float* A = half ? Ds : Ps;
#pragma unroll 2
    for (int r = 0; r < BM; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + r * LDS +
                                                         8 * kg);
      const float4 a1 = *reinterpret_cast<const float4*>(A + r * LDS +
                                                         8 * kg + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float* Yr = (half ? Qs : dOs) + r * LDQ + 4 * cg;
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        if (64 * jj >= width_a) break;
        const float4 y = *reinterpret_cast<const float4*>(Yr + 64 * jj);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * jj] = fmaf(a[i], y.x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(a[i], y.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(a[i], y.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(a[i], y.w, acc[i][4 * jj + 3]);
        }
      }
    }
    __syncthreads();                       // buffer buf, P and dS free
    rt = nx;
  }
  cp_wait<0>();

  float* out = half ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kj = k0 + 8 * kg + i;
    if (kj >= g.Tk) continue;
    float* dst = out + ((static_cast<long long>(b) * g.Tk + kj) * g.KV +
                        kvh) * width_a;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const int c = 4 * cg + 64 * jj;
      if (c < width_a)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                        acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    }
  }
}

// ------------------------------------------------------------ launchers

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

// Whether n blocks would leave the card under two blocks an SM.
bool few_blocks(long long n) { return n < 2LL * sm_count(); }

template <int D>
cudaError_t bwd_f32(const float* q, const float* k, const float* v,
                    const float* o, const float* dout, const float* lse,
                    float* dq, float* dk, float* dv, float* dvec, int B,
                    const Geo& g, cudaStream_t st) {
  using Q = DqF32<D>;
  static_assert(Q::SMEM <= MAX_SMEM, "f32 dQ tile exceeds shared memory");
  const int bq = Q::BM / g.G;
  const int n_qt = (g.S + bq - 1) / bq;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  if (err != cudaSuccess) return err;
  bwd_dq_f32<D><<<dim3(g.KV, B, n_qt), Q::NT, Q::SMEM, st>>>(
      q, k, v, o, dout, lse, dq, dvec, g, bq, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv = [&](auto kernel, int kb, int nt, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(g.KV, B, (g.Tk + kb - 1) / kb), nt, smem, st>>>(
        q, k, v, dout, lse, dvec, dk, dv, g);
    return cudaGetLastError();
  };
  using K32 = DkvF32<D, 32>;
  static_assert(K32::SMEM <= MAX_SMEM, "f32 dK/dV tile exceeds shared memory");
  if constexpr (D <= 192) {
    using K64 = DkvF32<D, 64>;
    static_assert(K64::SMEM <= MAX_SMEM, "f32 dK/dV tile exceeds shared "
                                         "memory");
    if (!few_blocks(static_cast<long long>((g.Tk + 63) / 64) * g.KV * B))
      return dkdv(bwd_dkdv_f32<D, 64>, 64, K64::NT, K64::SMEM);
  }
  return dkdv(bwd_dkdv_f32<D, 32>, 32, K32::NT, K32::SMEM);
}

template <int D>
cudaError_t bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                     const bf16* o, const bf16* dout, const float* lse,
                     bf16* dq, bf16* dk, bf16* dv, float* dvec, int B,
                     const Geo& g, cudaStream_t st) {
  constexpr int NWG = D <= 128 ? 2 : 1;
  using Q = DqBf16<D, NWG>;
  static_assert(Q::SMEM <= MAX_SMEM, "bf16 dQ tile exceeds shared memory");
  const int bq = Q::BM / g.G;
  const int n_qt = (g.S + bq - 1) / bq;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_bf16<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Q::SMEM);
  if (err != cudaSuccess) return err;
  bwd_dq_bf16<D, NWG><<<dim3(g.KV, B, n_qt), Q::NT, Q::SMEM, st>>>(
      q, k, v, o, dout, lse, dq, dvec, g, bq, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv = [&](auto kernel, int kb, int nt, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(g.KV, B, (g.Tk + kb - 1) / kb), nt, smem, st>>>(
        q, k, v, dout, lse, dvec, dk, dv, g);
    return cudaGetLastError();
  };
  constexpr bool SPLIT = D == 256;
  using K = DkvBf16<D, SPLIT>;
  static_assert(K::SMEM <= MAX_SMEM, "bf16 dK/dV tile exceeds shared memory");
  return dkdv(bwd_dkdv_bf16<D, SPLIT>, K::KB, K::NT, K::SMEM);
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv), the forward's
// output o, its gradient dout (B, S, H, hdv) and its base-2 log-sum-exp
// lse (B, S, H) f32 -> dq, dk, dv of the shapes of q, k, v; all but lse
// of one type (dtype 0: float, 1: bf16), contiguous, head dims multiples
// of 16, at most 64 query heads a KV head.  dvec (B, S, H) f32 scratch.
int flash_attention_backward_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* dq, void* dk, void* dv,
                                    void* dvec, int dtype, int B, int S,
                                    int Tk, int H, int KV, int hd, int hdv,
                                    int causal, int window, int q_start,
                                    float softcap, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > MAX_GROUP || hd <= 0 || hd > MAX_HEAD_DIM || hd % 16 != 0 ||
      hdv <= 0 || hdv > MAX_HEAD_DIM || hdv % 16 != 0 || window < 0 ||
      softcap < 0.f || B > 65535 || KV > 65535 || q_start < 0)
    return cudaErrorInvalidValue;
  const Geo g{S,     Tk,     H,     KV,    H / KV,
              hd,    hdv,    causal, window, scale,
              1.f / static_cast<float>(Tk), logit_scale(scale, softcap),
              q_start};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(dvec);
  const int dmax = hd > hdv ? hd : hdv;
  auto run = [&](auto d) -> int {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return bwd_f32<D>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o),
          static_cast<const float*>(dout), lf, static_cast<float*>(dq),
          static_cast<float*>(dk), static_cast<float*>(dv), df, B, g, st);
    if constexpr (D != 192) {
      if (dtype == 1)
        return bwd_bf16<D>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(o),
            static_cast<const bf16*>(dout), lf, static_cast<bf16*>(dq),
            static_cast<bf16*>(dk), static_cast<bf16*>(dv), df, B, g, st);
    }
    return cudaErrorInvalidValue;
  };
  if (dmax <= 64) return run(std::integral_constant<int, 64>());
  if (dmax <= 128) return run(std::integral_constant<int, 128>());
  if (dmax <= 192 && dtype == 0)
    return run(std::integral_constant<int, 192>());
  return run(std::integral_constant<int, 256>());
}

}  // extern "C"
