// The MoE layer's routed experts for a decode-sized call, for Hopper
// (sm_90a): two grouped kernels that read the routing on the device.
//
//   grouped_gate_up_kernel<T, R, GELU>  h = act(x Wg[e]) * (x Wu[e])
//   grouped_down_kernel<T, R>           y = h Wd[e]
//
// They replace no Pallas kernel: the reference (src/repro/models/moe.py,
// _moe_mlp_dense) runs its experts as einsums over an (E, capacity, D)
// buffer under XLA.  The port's segment loop (models/moe.py, _experts)
// reads the experts' segment lengths back to the host and launches about
// eight kernels an expert hit, so on a decode step the host, not the
// card, sets the pace.  Here one launch of each kernel serves every
// expert of a layer, and nothing is read back.
//
// Inputs: x (T, D) and the weights w_gate, w_up (E, D, F) and w_down
// (E, F, D), row-major, all of one type T (float or bf16); the routing of
// the T * k (token, slot) pairs, token-major: expert (int64) and keep (one
// byte, 0 or 1).  Outputs: h (T * k, F) and y (T * k, D) of type T, one
// row a pair; a pair that is not kept (or names no expert) gets a zero
// row of y and no row of h.  The caller scales each row of y by its gate
// weight and sums the k slots.
//
// Bound: device-memory bytes.  At a decode step's T <= 32 tokens an expert
// takes at most T pairs, so each weight element read serves at most T
// multiply-adds; at deepseek-moe-16b's widths (D 2048, F 1408, f32) the
// ~35 experts a layer of 8 tokens hits are 1.2 GB, 0.36 ms at 3.35 TB/s,
// against at most 8 FMAs a 4-byte element.  The design streams each hit
// expert's weights once, where they lie (no copy, no transposition):
//
//  * A block owns (expert e, a tile of 64 output columns) and 8 warps.
//    Warp 0 reads the call's T * k expert ids and keep flags and lists the
//    pairs of e in pair order (a ballot and a prefix count a 32-pair run),
//    so the rows of an expert are in queue order.  A block whose expert
//    has no pair returns at once.
//  * The input rows of the block's pairs (x's rows of their tokens, or h's
//    rows) are staged in shared memory as f32, transposed ([k][pair]), in
//    chunks of the contraction dim, so one 16-byte broadcast load gives a
//    row's value for four pairs.
//  * Each lane owns two adjacent columns (one 8-byte load a row in f32, 4
//    bytes in bf16; a warp reads 256 or 128 contiguous bytes a row of a
//    matrix); the warps split the contraction dim in runs of 8 rows, each
//    warp loading its 8 rows of every matrix (16 loads a lane in flight,
//    evict-first) before it multiplies.  Sums are f32 on the CUDA cores
//    (no TF32: the configurations' float32 is the full f32).
//  * The warps' partial sums meet in shared memory, 8 pairs at a time, and
//    are added in warp order: the result does not depend on scheduling,
//    and no atomics are used.
//  * R (8, 16, 32) is the most pairs an expert can take (the call's tokens
//    rounded up), a template parameter so the accumulators stay in
//    registers; inside, a block whose expert took at most 8 (16) pairs
//    runs the 8-row (16-row) body, so spare rows cost no multiply-adds.
//
// bf16 rounds where the segment loop's cuBLAS calls round their outputs:
// x Wg and x Wu, the activation, their product, and h Wd, each to bf16.
// The activation is silu(g) = g / (1 + exp(-g)) or, with GELU, the tanh
// approximation 0.5 g (1 + tanh(sqrt(2 / pi) (g + 0.044715 g^3))).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 2;                // adjacent columns a lane
constexpr int TILE = 32 * VEC;        // output columns a block
constexpr int STEP = 8;               // rows a warp loads before it multiplies
constexpr int RED_ROWS = 8;           // pairs reduced over the warps at a time
constexpr int MAX_TOKENS = 32;
constexpr int MAX_PAIRS = 512;        // T * k a call
constexpr int STAGE = 8192;           // floats: the staged rows, then the sums
static_assert(WARPS * RED_ROWS * 2 * TILE <= STAGE, "reduction buffer");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T (round to nearest even) and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// two adjacent elements from 8 (f32) or 4 (bf16) aligned bytes, streamed
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(p));
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + expf(-g));
}
__device__ __forceinline__ float gelu_tanh(float g) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// Warp 0: the pairs of expert e (e == E: the pairs kept by no expert, not
// kept or naming none) in pair order into list; returns their count.
__device__ int find_pairs(const int64_t* __restrict__ expert,
                          const uint8_t* __restrict__ keep, int P, int E,
                          int e, int* list) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    bool hit = false;
    if (p < P) {
      const int64_t ex = expert[p];
      const bool kept = keep[p] != 0 && ex >= 0 && ex < E;
      hit = e < E ? kept && ex == e : !kept;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = p;
    n += __popc(m);
  }
  return n;
}

// The block's cnt <= R pairs (list) against NMAT matrices w[m] (K x N,
// row-major) on the columns [col0, col0 + TILE): input row n is in[list[n]
// / div] (K elements); epi(pair, column, sums) gets the f32 sums of the
// NMAT products at each (pair, column) of the tile, once each.
template <typename T, int R, int NMAT, class Epi>
__device__ __forceinline__ void run_rows(const T* __restrict__ in, int div,
                                         const int* list, int cnt,
                                         const T* __restrict__ w0,
                                         const T* __restrict__ w1, int K,
                                         int N, int col0, float* stage,
                                         Epi epi) {
  constexpr int KC = STAGE / R;   // rows staged a chunk, a multiple of 64
  static_assert(KC % (WARPS * STEP) == 0, "chunk");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = col0 + lane * VEC;
  const bool col_ok = col < N;    // N is even, so col + 1 < N too
  const T* w[2] = {w0, w1};
  float acc[R][NMAT][VEC];
#pragma unroll
  for (int n = 0; n < R; ++n)
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[n][m][v] = 0.f;

  for (int c0 = 0; c0 < K; c0 += KC) {
    const int len = min(KC, K - c0);
    const int padded = (len + STEP - 1) / STEP * STEP;
    __syncthreads();              // the last chunk or sums are read
    for (int i = threadIdx.x; i < padded * R; i += THREADS) {
      const int n = i / padded, kk = i - n * padded;
      float v = 0.f;
      if (n < cnt && kk < len)
        v = to_f(in[static_cast<size_t>(list[n] / div) * K + c0 + kk]);
      stage[kk * R + n] = v;
    }
    __syncthreads();
    for (int g = warp * STEP; g < len; g += WARPS * STEP) {
      float wv[STEP][NMAT][VEC];
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        const bool ok = col_ok && g + u < len;
        const size_t off = static_cast<size_t>(c0 + g + u) * N + col;
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          if (ok) {
            load2(w[m] + off, wv[u][m][0], wv[u][m][1]);
          } else {
            wv[u][m][0] = 0.f;
            wv[u][m][1] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        const float* xs = stage + (g + u) * R;
#pragma unroll
        for (int n4 = 0; n4 < R; n4 += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + n4);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[n4 + j][m][v] =
                    fmaf(xv[j], wv[u][m][v], acc[n4 + j][m][v]);
        }
      }
    }
  }

  // the warps' partial sums, RED_ROWS pairs at a time, added in warp order
#pragma unroll
  for (int n0 = 0; n0 < R; n0 += RED_ROWS) {
    if (n0 >= cnt) break;         // cnt is the same for the whole block
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RED_ROWS; ++j)
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          stage[((warp * RED_ROWS + j) * NMAT + m) * TILE + lane * VEC + v] =
              acc[n0 + j][m][v];
    __syncthreads();
    for (int i = threadIdx.x; i < RED_ROWS * TILE; i += THREADS) {
      const int j = i / TILE, c = i - j * TILE;
      if (n0 + j < cnt && col0 + c < N) {
        float s[NMAT];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          s[m] = 0.f;
#pragma unroll
          for (int wp = 0; wp < WARPS; ++wp)
            s[m] += stage[((wp * RED_ROWS + j) * NMAT + m) * TILE + c];
        }
        epi(list[n0 + j], col0 + c, s);
      }
    }
  }
}

// Runs the block's cnt pairs R at a time, each run by the smallest body
// (8, 16 or R rows) that holds it.
template <typename T, int R, int NMAT, class Epi>
__device__ __forceinline__ void run_pairs(const T* in, int div,
                                          const int* list, int cnt,
                                          const T* w0, const T* w1, int K,
                                          int N, int col0, float* stage,
                                          Epi epi) {
  for (int base = 0; base < cnt; base += R) {
    const int n = min(R, cnt - base);
    if constexpr (R == 8) {
      run_rows<T, 8, NMAT>(in, div, list + base, n, w0, w1, K, N, col0,
                           stage, epi);
    } else if constexpr (R == 16) {
      if (n <= 8)
        run_rows<T, 8, NMAT>(in, div, list + base, n, w0, w1, K, N, col0,
                             stage, epi);
      else
        run_rows<T, 16, NMAT>(in, div, list + base, n, w0, w1, K, N, col0,
                              stage, epi);
    } else {
      if (n <= 8)
        run_rows<T, 8, NMAT>(in, div, list + base, n, w0, w1, K, N, col0,
                             stage, epi);
      else if (n <= 16)
        run_rows<T, 16, NMAT>(in, div, list + base, n, w0, w1, K, N, col0,
                              stage, epi);
      else
        run_rows<T, R, NMAT>(in, div, list + base, n, w0, w1, K, N, col0,
                             stage, epi);
    }
  }
}

// grid (ceil(F / TILE), E): h[p] = act(x[p / k] Wg[e]) * (x[p / k] Wu[e])
template <typename T, int R, bool GELU>
__global__ void __launch_bounds__(THREADS, R == 32 ? 1 : 2)
    grouped_gate_up_kernel(const T* __restrict__ x,
                           const int64_t* __restrict__ expert,
                           const uint8_t* __restrict__ keep,
                           const T* __restrict__ w_gate,
                           const T* __restrict__ w_up, T* __restrict__ h,
                           int P, int k, int E, int D, int F) {
  __shared__ int list[MAX_PAIRS];
  __shared__ int count;
  __shared__ __align__(16) float stage[STAGE];
  const int e = blockIdx.y, col0 = blockIdx.x * TILE;
  if (threadIdx.x < 32) {
    const int n = find_pairs(expert, keep, P, E, e, list);
    if (threadIdx.x == 0) count = n;
  }
  __syncthreads();
  const int cnt = count;
  if (cnt == 0) return;
  const size_t off = static_cast<size_t>(e) * D * F;
  auto epi = [&](int p, int c, const float* s) {
    const float g = round_to<T>(s[0]), u = round_to<T>(s[1]);
    const float a = round_to<T>(GELU ? gelu_tanh(g) : silu(g));
    h[static_cast<size_t>(p) * F + c] = from_f<T>(a * u);
  };
  run_pairs<T, R, 2>(x, k, list, cnt, w_gate + off, w_up + off, D, F, col0,
                     stage, epi);
}

// grid (ceil(D / TILE), E + 1): y[p] = h[p] Wd[e]; the last row of blocks
// writes the zero rows of the pairs kept by no expert
template <typename T, int R>
__global__ void __launch_bounds__(THREADS, R == 32 ? 1 : 2)
    grouped_down_kernel(const T* __restrict__ h,
                        const int64_t* __restrict__ expert,
                        const uint8_t* __restrict__ keep,
                        const T* __restrict__ w_down, T* __restrict__ y,
                        int P, int E, int D, int F) {
  __shared__ int list[MAX_PAIRS];
  __shared__ int count;
  __shared__ __align__(16) float stage[STAGE];
  const int e = blockIdx.y, col0 = blockIdx.x * TILE;
  if (threadIdx.x < 32) {
    const int n = find_pairs(expert, keep, P, E, e, list);
    if (threadIdx.x == 0) count = n;
  }
  __syncthreads();
  const int cnt = count;
  if (cnt == 0) return;
  if (e == E) {
    for (int i = threadIdx.x; i < cnt * TILE; i += THREADS) {
      const int n = i / TILE, c = col0 + i - n * TILE;
      if (c < D) y[static_cast<size_t>(list[n]) * D + c] = from_f<T>(0.f);
    }
    return;
  }
  auto epi = [&](int p, int c, const float* s) {
    y[static_cast<size_t>(p) * D + c] = from_f<T>(s[0]);
  };
  run_pairs<T, R, 1>(h, 1, list, cnt,
                     w_down + static_cast<size_t>(e) * F * D, nullptr, F, D,
                     col0, stage, epi);
}

template <typename T, int R, bool GELU>
int launch(const void* x, const int64_t* expert, const uint8_t* keep,
           const void* w_gate, const void* w_up, const void* w_down,
           void* h, void* y, int T_, int k, int E, int D, int F,
           cudaStream_t st) {
  const int P = T_ * k;
  const dim3 block(THREADS);
  grouped_gate_up_kernel<T, R, GELU>
      <<<dim3((F + TILE - 1) / TILE, E), block, 0, st>>>(
          static_cast<const T*>(x), expert, keep,
          static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
          static_cast<T*>(h), P, k, E, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grouped_down_kernel<T, R><<<dim3((D + TILE - 1) / TILE, E + 1), block, 0,
                              st>>>(static_cast<const T*>(h), expert, keep,
                                    static_cast<const T*>(w_down),
                                    static_cast<T*>(y), P, E, D, F);
  return cudaGetLastError();
}

template <typename T, bool GELU>
int launch_rows(const void* x, const int64_t* expert, const uint8_t* keep,
                const void* w_gate, const void* w_up, const void* w_down,
                void* h, void* y, int T_, int k, int E, int D, int F,
                cudaStream_t st) {
  if (T_ <= 8)
    return launch<T, 8, GELU>(x, expert, keep, w_gate, w_up, w_down, h, y,
                              T_, k, E, D, F, st);
  if (T_ <= 16)
    return launch<T, 16, GELU>(x, expert, keep, w_gate, w_up, w_down, h, y,
                               T_, k, E, D, F, st);
  return launch<T, 32, GELU>(x, expert, keep, w_gate, w_up, w_down, h, y,
                             T_, k, E, D, F, st);
}

}  // namespace

extern "C" {

// x (T, D), expert (T * k) int64, keep (T * k) bytes, w_gate / w_up (E, D,
// F), w_down (E, F, D), all contiguous, weights 8-byte aligned; dtype 0:
// float, 1: bf16 (x, the weights, h and y alike); act 0: silu, 1: gelu
// (tanh).  Writes h (T * k, F) and y (T * k, D); 1 <= T <= 32, T * k <=
// 512, D and F even.
int grouped_experts_launch(const void* x, const void* expert,
                           const void* keep, const void* w_gate,
                           const void* w_up, const void* w_down, void* h,
                           void* y, int dtype, int act, int T_, int k, int E,
                           int D, int F, void* stream) {
  if (T_ < 1 || T_ > MAX_TOKENS || k < 1 || T_ * k > MAX_PAIRS || E < 1 ||
      D < 2 || F < 2 || D % 2 || F % 2 || act < 0 || act > 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* ex = static_cast<const int64_t*>(expert);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
#define GROUPED_CASE(TYPE)                                                  \
  return act ? launch_rows<TYPE, true>(x, ex, kp, w_gate, w_up, w_down, h,  \
                                       y, T_, k, E, D, F, st)               \
             : launch_rows<TYPE, false>(x, ex, kp, w_gate, w_up, w_down, h, \
                                        y, T_, k, E, D, F, st);
  if (dtype == 0) GROUPED_CASE(float)
  if (dtype == 1) GROUPED_CASE(bf16)
#undef GROUPED_CASE
  return cudaErrorInvalidValue;
}

// the most tokens and (token, slot) pairs a call takes
int grouped_max_tokens(void) { return MAX_TOKENS; }
int grouped_max_pairs(void) { return MAX_PAIRS; }

}  // extern "C"
