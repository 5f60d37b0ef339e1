// The backward of flash attention for Hopper (sm_90a): dQ, dK and dV of
// the forward in attention.cu (flash_kernel_f32<D>, flash_kernel_bf16<D>).
// The reference has no Pallas counterpart: it differentiates its jnp
// attention (_sdpa) with XLA's autodiff.  This is the port's own kernel,
// the backward of kernels/attention.py::FlashAttention.
//
// Semantics: those of the forward and of its plain version.  Logits are
// s = scale * q.k, capped to c * tanh(s / c) when softcap c > 0; a key is
// valid for query position i when j < T, j <= i (causal) and i - j <
// window (window > 0).  P = softmax over the valid keys; a row with no
// valid key (only possible with a window) has P = 1/T over all T keys
// (the forward's -2e38 masks make every logit equal), so each key's dV
// gets dO / T from it and no gradient flows to its q or to any k.  With
// D_i = rowsum(dO_i * O_i):
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . V_j - D_i) * (1 - tanh^2) * scale   (valid only)
//   dQ_i = sum_j dS_ij K_j,   dK_j = sum_i dS_ij Q_i
// GQA: query head h reads KV head h / G, so dK and dV sum over the G
// heads of the group.
//
// Design (simple; f32 on the CUDA cores for f32 and bf16 inputs, f32
// accumulation, no atomics, no library call).  A block's query rows are
// the (position, head) pairs of one KV head's G heads, flattened
// position-major, BM at a time; keys come BK at a time.  Tiles are staged
// in shared memory as f32 with a padded row stride (D + 1), so the
// 16 lanes that read 16 keys of one column hit 16 banks.  256 threads as
// 16 x 16: in a (rows x keys) product a thread owns rows ty + 16i and keys
// tx + 16j; in an accumulation it owns rows (or keys) ty + 16i and
// columns tx + 16j.  The 16 lanes of a row form one half-warp, so row
// reductions are four shuffles.
//   flash_bwd_dq_kernel: one block a (query tile, KV head, batch).  Pass
//     1 walks the key tiles the masks leave and takes each row's
//     log-sum-exp (recomputed from Q and K: the forward keeps none) and D;
//     both go to global memory for the next kernel.  Pass 2 walks the
//     same tiles again: S, P = exp(s - lse), dP = dO V^T, dS, and dQ +=
//     dS K in registers; dQ is written once.
//   flash_bwd_dkdv_kernel: one block a (key tile, KV head, batch), K and V
//     held in shared memory.  It walks the query tiles of all G heads
//     (skipping tiles the masks leave no key of this tile in, unless they
//     hold a keyless row), recomputes S, P and dS from the saved lse and
//     D, and accumulates dV += P^T dO and dK += dS^T Q in registers, so
//     the GQA sum stays inside the block.
// Head dims are compile-time ceilings D in {64, 128, 256} (BM = BK = 64,
// or 32 at D = 256 for shared memory); the wrapper pads head dims to a
// multiple of 16.  Plain C interface (loaded with ctypes); the launcher
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it
// does not take) and launches on the caller's stream.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;               // threads a block (16 x 16)
constexpr int MAX_HEAD_DIM = 256;
constexpr int MAX_GROUP = 64;
constexpr int MAX_SMEM = 232448;      // a block's shared memory on sm_90

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

template <int D> struct BwdTile {
  static constexpr int BM = D <= 128 ? 64 : 32;   // query rows a tile
  static constexpr int BK = BM;                   // keys a tile
  static constexpr int RM = BM / 16;              // rows (keys) a thread
  static constexpr int CD = D / 16;               // columns a thread
  static constexpr int LD = D + 1;                // Q, dO, K, V row stride
  static constexpr int LP = BK + 1;               // P, dS row stride
  static constexpr int TILE = BM * LD;
  static constexpr int SMEM = static_cast<int>(sizeof(float)) *
                              (4 * TILE + 2 * BM * LP + 2 * BM);
};

struct Geo {
  int S, Tk, H, KV, G, hd, hdv, causal, window;
  float scale, softcap;
  // the valid keys of query position i are [lo(i), hi(i)]; none if lo > hi
  __device__ __forceinline__ int lo(int i) const {
    return window > 0 ? max(0, i - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int i) const {
    return causal ? min(i, Tk - 1) : Tk - 1;
  }
  // the capped logit of a raw product, and the cap's derivative factor
  __device__ __forceinline__ float logit(float dot, float* dcap) const {
    const float s = dot * scale;
    if (softcap > 0.f) {
      const float th = tanhf(s / softcap);
      *dcap = 1.f - th * th;
      return softcap * th;
    }
    *dcap = 1.f;
    return s;
  }
};

// Rows of one tile into shared memory as f32 (stride LD), columns past
// ncols and rows whose offset is negative zero-filled.  off(r) is the
// element offset of row r in src.
template <int ROWS, int D, int LD, typename T, typename Off>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Off off, int ncols) {
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, c = e % D;
    const long long o = off(r);
    dst[r * LD + c] = (o >= 0 && c < ncols) ? to_f(src[o + c]) : 0.f;
  }
}

// acc[i][j] = sum_d a[(ty + 16i)][d] * b[(tx + 16j)][d] over d < n.
template <int RM, int LD>
__device__ __forceinline__ void tile_dot(float (&acc)[RM][RM],
                                         const float* a, const float* b,
                                         int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RM; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < n; ++d) {
    float x[RM], y[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) x[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RM; ++j) y[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ dvec_out,
                    Geo g) {
  using C = BwdTile<D>;
  constexpr int BM = C::BM, BK = C::BK, RM = C::RM, CD = C::CD;
  constexpr int LD = C::LD, LP = C::LP;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + C::TILE;
  float* sK = sdO + C::TILE;
  float* sV = sK + C::TILE;
  float* sS = sV + C::TILE;
  float* sL = sS + 2 * BM * LP;
  float* sD = sL + BM;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = g.S * g.G;
  const int r0 = blockIdx.x * BM;
  // the (b, position, head) index of tile row r, or -1 past the rows
  auto row_idx = [&](int r) -> long long {
    const int R = r0 + r;
    if (R >= rows) return -1;
    const int pos = R / g.G;
    return (static_cast<long long>(b) * g.S + pos) * g.H + kvh * g.G +
           (R - pos * g.G);
  };
  load_tile<BM, D, LD>(sQ, q, [&](int r) {
    const long long i = row_idx(r);
    return i < 0 ? -1 : i * g.hd;
  }, g.hd);
  load_tile<BM, D, LD>(sdO, dout, [&](int r) {
    const long long i = row_idx(r);
    return i < 0 ? -1 : i * g.hdv;
  }, g.hdv);
  __syncthreads();

  // D = rowsum(dO * O), a half-warp a row
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    const long long ri = row_idx(r);
    float acc = 0.f;
    if (ri >= 0)
      for (int d = tx; d < g.hdv; d += 16)
        acc += sdO[r * LD + d] * to_f(o[ri * g.hdv + d]);
    acc = half_warp_sum(acc);
    if (tx == 0) sD[r] = acc;
  }

  const int last = min(r0 + BM, rows) - 1;
  const int p0 = r0 / g.G, p1 = last / g.G;
  const int klo = g.lo(p0), khi = g.hi(p1);
  const int kt0 = klo / BK, kt1 = klo <= khi ? khi / BK : kt0 - 1;
  auto key_off = [&](int c, int k0, int n) -> long long {
    const int kj = k0 + c;
    if (kj >= g.Tk) return -1;
    return ((static_cast<long long>(b) * g.Tk + kj) * g.KV + kvh) * n;
  };
  auto valid = [&](int r, int kj) -> bool {
    const int R = r0 + r;
    if (R >= rows || kj >= g.Tk) return false;
    const int pos = R / g.G;
    return kj >= g.lo(pos) && kj <= g.hi(pos);
  };

  // pass 1: each row's max and sum over its valid keys
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * BK;
    load_tile<BK, D, LD>(sK, k, [&](int c) { return key_off(c, k0, g.hd); },
                         g.hd);
    __syncthreads();
    float acc[RM][RM];
    tile_dot<RM, LD>(acc, sQ, sK, g.hd, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        if (!valid(ty + 16 * i, k0 + tx + 16 * j)) continue;
        float dcap;
        const float s = g.logit(acc[i][j], &dcap);
        if (s > m[i]) {
          l[i] = l[i] * expf(m[i] - s) + 1.f;
          m[i] = s;
        } else {
          l[i] += expf(s - m[i]);
        }
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float mx = m[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float part = m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mx);
    const float sum = half_warp_sum(part);
    const int r = ty + 16 * i;
    if (tx == 0) {
      // a row with no valid key never reads its lse
      const float lse = sum > 0.f ? mx + logf(sum) : 0.f;
      sL[r] = lse;
      const long long ri = row_idx(r);
      if (ri >= 0) {
        lse_out[ri] = lse;
        dvec_out[ri] = sD[r];
      }
    }
  }
  __syncthreads();

  // pass 2: dQ += dS K
  float dqa[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dqa[i][j] = 0.f;
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * BK;
    load_tile<BK, D, LD>(sK, k, [&](int c) { return key_off(c, k0, g.hd); },
                         g.hd);
    load_tile<BK, D, LD>(sV, v, [&](int c) { return key_off(c, k0, g.hdv); },
                         g.hdv);
    __syncthreads();
    float sacc[RM][RM], pacc[RM][RM];
    tile_dot<RM, LD>(sacc, sQ, sK, g.hd, ty, tx);
    tile_dot<RM, LD>(pacc, sdO, sV, g.hdv, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float ds = 0.f;
        if (valid(r, k0 + c)) {
          float dcap;
          const float s = g.logit(sacc[i][j], &dcap);
          const float p = expf(s - sL[r]);
          ds = p * (pacc[i][j] - sD[r]) * dcap * g.scale;
        }
        sS[r * LP + c] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RM], kk[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sS[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kk[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) dqa[i][j] = fmaf(a[i], kk[j], dqa[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long ri = row_idx(ty + 16 * i);
    if (ri < 0) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int c = tx + 16 * j;
      if (c < g.hd) dq[ri * g.hd + c] = from_f<T>(dqa[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, T* __restrict__ dk,
                      T* __restrict__ dv, Geo g) {
  using C = BwdTile<D>;
  constexpr int BM = C::BM, BK = C::BK, RM = C::RM, CD = C::CD;
  constexpr int LD = C::LD, LP = C::LP;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + C::TILE;
  float* sQ = sV + C::TILE;
  float* sdO = sQ + C::TILE;
  float* sP = sdO + C::TILE;
  float* sS = sP + BM * LP;
  float* sL = sS + BM * LP;
  float* sD = sL + BM;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = g.S * g.G;
  const int k0 = blockIdx.x * BK;
  const int ke = min(k0 + BK, g.Tk) - 1;
  auto key_off = [&](int c, int n) -> long long {
    const int kj = k0 + c;
    if (kj >= g.Tk) return -1;
    return ((static_cast<long long>(b) * g.Tk + kj) * g.KV + kvh) * n;
  };
  load_tile<BK, D, LD>(sK, k, [&](int c) { return key_off(c, g.hd); }, g.hd);
  load_tile<BK, D, LD>(sV, v, [&](int c) { return key_off(c, g.hdv); },
                       g.hdv);

  float dka[RM][CD], dva[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dka[i][j] = dva[i][j] = 0.f;
  const float uniform = 1.f / static_cast<float>(g.Tk);

  const int n_rt = (rows + BM - 1) / BM;
  for (int rt = 0; rt < n_rt; ++rt) {
    const int r0 = rt * BM;
    const int last = min(r0 + BM, rows) - 1;
    const int p0 = r0 / g.G, p1 = last / g.G;
    const bool keyless = g.lo(p1) > g.hi(p1);   // the tile's last row
    if (!keyless && !(ke >= g.lo(p0) && k0 <= g.hi(p1))) continue;
    auto row_idx = [&](int r) -> long long {
      const int R = r0 + r;
      if (R >= rows) return -1;
      const int pos = R / g.G;
      return (static_cast<long long>(b) * g.S + pos) * g.H + kvh * g.G +
             (R - pos * g.G);
    };
    load_tile<BM, D, LD>(sQ, q, [&](int r) {
      const long long i = row_idx(r);
      return i < 0 ? -1 : i * g.hd;
    }, g.hd);
    load_tile<BM, D, LD>(sdO, dout, [&](int r) {
      const long long i = row_idx(r);
      return i < 0 ? -1 : i * g.hdv;
    }, g.hdv);
    for (int r = threadIdx.x; r < BM; r += NT) {
      const long long i = row_idx(r);
      sL[r] = i < 0 ? 0.f : lse[i];
      sD[r] = i < 0 ? 0.f : dvec[i];
    }
    __syncthreads();
    float sacc[RM][RM], pacc[RM][RM];
    tile_dot<RM, LD>(sacc, sQ, sK, g.hd, ty, tx);
    tile_dot<RM, LD>(pacc, sdO, sV, g.hdv, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int R = r0 + r, kj = k0 + c;
        float p = 0.f, ds = 0.f;
        if (R < rows && kj < g.Tk) {
          const int pos = R / g.G;
          const int lo = g.lo(pos), hi = g.hi(pos);
          if (lo > hi) {
            p = uniform;
          } else if (kj >= lo && kj <= hi) {
            float dcap;
            const float s = g.logit(sacc[i][j], &dcap);
            p = expf(s - sL[r]);
            ds = p * (pacc[i][j] - sD[r]) * dcap * g.scale;
          }
        }
        sP[r * LP + c] = p;
        sS[r * LP + c] = ds;
      }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BM; ++r) {
      float pp[RM], dd[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pp[i] = sP[r * LP + ty + 16 * i];
        dd[i] = sS[r * LP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float od = sdO[r * LD + tx + 16 * j];
        const float qd = sQ[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          dva[i][j] = fmaf(pp[i], od, dva[i][j]);
          dka[i][j] = fmaf(dd[i], qd, dka[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= g.Tk) continue;
    const long long base = (static_cast<long long>(b) * g.Tk + kj) * g.KV +
                           kvh;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int c = tx + 16 * j;
      if (c < g.hd) dk[base * g.hd + c] = from_f<T>(dka[i][j]);
      if (c < g.hdv) dv[base * g.hdv + c] = from_f<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t bwd_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* dvec, int B, const Geo& g,
                       cudaStream_t stream) {
  using C = BwdTile<D>;
  static_assert(C::SMEM <= MAX_SMEM, "backward tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_rt = (g.S * g.G + C::BM - 1) / C::BM;
  const int n_kt = (g.Tk + C::BK - 1) / C::BK;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<dim3(n_rt, g.KV, B), NT, C::SMEM, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse,
      dvec, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(n_kt, g.KV, B), NT, C::SMEM, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
      g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv), the forward's
// output o and its gradient dout (B, S, H, hdv) -> dq, dk, dv of the
// shapes of q, k, v; all of one type (dtype 0: float, 1: bf16),
// contiguous, head dims multiples of 16, at most 64 query heads a KV head.
// lse and dvec (B, S, H) f32 scratch.
int flash_attention_backward_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, void* dq, void* dk,
                                    void* dv, void* lse, void* dvec,
                                    int dtype, int B, int S, int Tk, int H,
                                    int KV, int hd, int hdv, int causal,
                                    int window, float softcap, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > MAX_GROUP || hd <= 0 || hd > MAX_HEAD_DIM || hd % 16 != 0 ||
      hdv <= 0 || hdv > MAX_HEAD_DIM || hdv % 16 != 0 || window < 0 ||
      softcap < 0.f)
    return cudaErrorInvalidValue;
  const Geo g{S, Tk, H, KV, H / KV, hd, hdv, causal, window, scale, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  float* df = static_cast<float*>(dvec);
  const int dmax = hd > hdv ? hd : hdv;
#define BWD_CASE(D)                                                         \
  if (dmax <= D) {                                                          \
    if (dtype == 0)                                                         \
      return bwd_launch<float, D>(q, k, v, o, dout, dq, dk, dv, lf, df, B,  \
                                  g, st);                                   \
    if (dtype == 1)                                                         \
      return bwd_launch<bf16, D>(q, k, v, o, dout, dq, dk, dv, lf, df, B,   \
                                 g, st);                                    \
    return cudaErrorInvalidValue;                                           \
  }
  BWD_CASE(64)
  BWD_CASE(128)
  BWD_CASE(256)
#undef BWD_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
