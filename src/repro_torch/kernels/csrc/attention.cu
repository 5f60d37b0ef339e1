// The two attention kernels for Hopper (sm_90a): the hand-written CUDA
// counterparts of the Pallas kernels of src/repro/kernels/.
//
//   flash_kernel<T, DV>          <- _flash_kernel (flash_attn.py:47)
//   decode_partial_kernel<T>     <- _decode_kernel (decode_attn.py:26),
//   decode_combine_kernel           split over T chunks (flash-decoding)
//
// Both keep the reference's online softmax in f32: a masked logit is
// NEG = -2e38 (never -inf), so a row whose every key is masked averages
// v uniformly, as the reference's softmax does, and a row with one valid
// key wipes the masked ones out (exp(NEG - m) == 0 in f32).  Keys past the
// end of the sequence (a ragged last tile) are left out altogether.
//
// GQA: query head h reads KV head h / G (H = KV * G), the order of
// q.reshape(B, S, KV, G, hd) in the reference.
//
// flash_kernel: one block per (b, KV head, tile of query positions); the
// block's rows are the G heads of that KV head for bq = 64 / G positions,
// so every K/V tile is read once for the whole group.  A loop inside the
// block walks the K/V tiles of 64 keys (the Pallas grid's sequential ik
// axis); the running max, denominator and output accumulator stay in
// shared memory and registers across it.  Tiles that the causal and
// window masks remove for every row are skipped, unless some row of the
// block has no key at all (it then averages all T keys, as the reference
// does).  Scores and the P.V product are CUDA-core FMAs from shared-memory
// tiles: 4 rows x 4 keys a thread for the scores, 4 rows x DV columns for
// the accumulator.  Bound: at S = T = 1024, hd = 128 the causal product is
// ~69 GFLOP a layer against ~67 MB of q/k/v/out, far above the card's
// ridge, so the kernel is bound by operations; CUDA-core f32 is 67 TFLOP/s
// and a kernel on the tensor cores (wgmma) is later work.
//
// decode: pass 1 gives one block to (b, KV head, chunk of keys) and
// computes the G heads' partial (max, sum, accumulator) over its chunk;
// pass 2 merges the chunks of each head and divides by max(l, 1e-30), as
// _fin does.  One query token reads the whole K/V cache once, so the
// kernel is bound by device-memory bytes; splitting T over blocks puts
// B * KV * chunks blocks in flight instead of B * KV.
//
// Types: q, k, v (and flash's output) are float or bf16 (T); everything
// is accumulated in f32; decode's output is f32.  Plain C interface
// (loaded with ctypes): each launcher returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take) and launches on the
// caller's stream.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -2.0e38f;
constexpr uint32_t FULL = 0xffffffffu;

constexpr int FL_THREADS = 256;
constexpr int FL_ROWS = 64;        // (query position, head) rows a block
constexpr int FL_BK = 64;          // keys a tile
constexpr int FL_LDP = FL_BK + 1;  // row stride of the score tile
constexpr int MAX_HEAD_DIM = 256;

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_GB = 8;          // heads a pass over v
constexpr int DEC_MAX_CHUNK = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Odd row strides keep a column walk across 16 rows on 16 banks.
__host__ __device__ __forceinline__ int odd_stride(int n) {
  return (n & 1) ? n : n + 1;
}

// ------------------------------------------------------------------ flash

size_t flash_smem_bytes(int hd, int dv_cols) {
  const int ldq = odd_stride(hd);
  return sizeof(float) * (static_cast<size_t>(FL_ROWS) * ldq  // Qs
                          + static_cast<size_t>(FL_BK) * ldq  // Ks
                          + static_cast<size_t>(FL_BK) * dv_cols  // Vs
                          + static_cast<size_t>(FL_ROWS) * FL_LDP  // Ps
                          + 3 * FL_ROWS);                     // m, l, alpha
}

// Row r of a block is query position q0 + r / G of head kvh * G + r % G.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty * 4 + i (i < 4); in
// the scores it owns keys tx + 16 * j (j < 4), in the accumulator value
// columns tx + 16 * j (j < DV).
template <typename T, int DV>
__global__ void __launch_bounds__(FL_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
             int H, int KV, int hd, int hdv, int G, int bq, int causal,
             int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int ldq = odd_stride(hd);
  const int ldv = 16 * DV;
  float* Qs = smem;
  float* Ks = Qs + FL_ROWS * ldq;
  float* Vs = Ks + FL_BK * ldq;
  float* Ps = Vs + FL_BK * ldv;
  float* Ms = Ps + FL_ROWS * FL_LDP;
  float* Ls = Ms + FL_ROWS;
  float* As = Ls + FL_ROWS;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = bq * G;
  const int q_last = min(q0 + bq, S) - 1;

  for (int e = tid; e < FL_ROWS * hd; e += FL_THREADS) {
    const int r = e / hd, d = e - (e / hd) * hd;
    const int qp = q0 + r / G;
    float x = 0.f;
    if (r < rows && qp < S)
      x = to_f(q[((static_cast<long long>(b) * S + qp) * H + kvh * G + r % G)
                 * hd + d]);
    Qs[r * ldq + d] = x;
  }
  if (tid < FL_ROWS) {
    Ms[tid] = NEG;
    Ls[tid] = 0.f;
  }

  // The keys any row of the block attends to: row qp sees
  // [lo(qp), hi(qp)], both nondecreasing in qp.  A row with none makes
  // the block walk all T keys (that row then averages v).
  int k_lo = 0, k_hi = Tk - 1;
  bool empty_row = false;
  for (int qp = q0; qp <= q_last; ++qp) {
    const int lo = window > 0 ? max(0, qp - window + 1) : 0;
    const int hi = causal ? min(Tk - 1, qp) : Tk - 1;
    empty_row = empty_row || lo > hi;
  }
  if (!empty_row) {
    k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_hi = causal ? min(Tk - 1, q_last) : Tk - 1;
  }

  float acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[i][j] = 0.f;

  for (int k0 = (k_lo / FL_BK) * FL_BK; k0 <= k_hi; k0 += FL_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < FL_BK * hd; e += FL_THREADS) {
      const int j = e / hd, d = e - (e / hd) * hd;
      const int kp = k0 + j;
      Ks[j * ldq + d] =
          kp < Tk ? to_f(k[((static_cast<long long>(b) * Tk + kp) * KV + kvh)
                           * hd + d])
                  : 0.f;
    }
    for (int e = tid; e < FL_BK * ldv; e += FL_THREADS) {
      const int j = e / ldv, d = e - (e / ldv) * ldv;
      const int kp = k0 + j;
      Vs[e] = (kp < Tk && d < hdv)
                  ? to_f(v[((static_cast<long long>(b) * Tk + kp) * KV + kvh)
                           * hdv + d])
                  : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4+i against keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = q0 + r / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = r < rows && qp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && qp - kp < window;
        Ps[r * FL_LDP + c] = kp >= Tk ? -INFINITY : (ok ? x : NEG);
      }
    }
    __syncthreads();

    // online softmax update, 4 lanes a row
    {
      const int r = tid >> 2, part = tid & 3;
      float* pr = Ps + r * FL_LDP;
      float mx = -INFINITY;
      for (int c = part; c < FL_BK; c += 4) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < FL_BK; c += 4) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        As[r] = alpha;
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = As[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < FL_BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * FL_LDP + c];
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        const float vv = Vs[c * ldv + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qp = q0 + r / G;
    if (r >= rows || qp >= S) continue;
    const float denom = fmaxf(Ls[r], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * S + qp) * H + kvh * G + r % G)
                     * hdv;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      const int d = tx + 16 * j;
      if (d < hdv) o[d] = from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DV>
cudaError_t flash_launch(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int Tk, int H, int KV,
                         int hd, int hdv, int causal, int window,
                         float softcap, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int bq = FL_ROWS / G;
  const size_t smem = flash_smem_bytes(hd, 16 * DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + bq - 1) / bq, KV, B);
  flash_kernel<T, DV><<<grid, FL_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, KV, hd, hdv,
      G, bq, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_dispatch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Tk, int H, int KV,
                           int hd, int hdv, int causal, int window,
                           float softcap, float scale, cudaStream_t stream) {
#define FLASH_CASE(DV)                                                     \
  if (hdv <= 16 * DV)                                                      \
    return flash_launch<T, DV>(q, k, v, out, B, S, Tk, H, KV, hd, hdv,     \
                               causal, window, softcap, scale, stream);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(8)
  FLASH_CASE(16)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- decode

// Block (chunk c, KV head kvh, batch b): keys [c * chunk, c * chunk + n).
// Partials are laid out (B, KV, chunks, G) for m and l and
// (B, KV, chunks, G, hd) for the accumulator.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ valid, int Tk, int H,
                      int KV, int hd, int G, int chunk, int n_chunks,
                      float scale, float* __restrict__ m_out,
                      float* __restrict__ l_out,
                      float* __restrict__ acc_out) {
  extern __shared__ float smem[];
  float* Qs = smem;            // G x hd
  float* Ss = Qs + G * hd;     // G x chunk: logits, then probabilities
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * chunk;
  const int n = min(chunk, Tk - t0);

  const T* qb = q + (static_cast<long long>(b) * H + kvh * G) * hd;
  for (int e = tid; e < G * hd; e += DEC_THREADS) Qs[e] = to_f(qb[e]);
  __syncthreads();

  // logits: a warp a key, the key's hd values on the lanes
  for (int j = warp; j < n; j += DEC_WARPS) {
    const long long row = static_cast<long long>(b) * Tk + t0 + j;
    const T* kr = k + (row * KV + kvh) * hd;
    float kreg[MAX_HEAD_DIM / 32];
#pragma unroll
    for (int i = 0; i < MAX_HEAD_DIM / 32; ++i) {
      const int d = lane + 32 * i;
      kreg[i] = d < hd ? to_f(kr[d]) : 0.f;
    }
    const bool ok = valid[row] != 0;
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_HEAD_DIM / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part = fmaf(Qs[g * hd + d], kreg[i], part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(FULL, part, o);
      if (lane == 0) Ss[g * chunk + j] = ok ? part * scale : NEG;
    }
  }
  __syncthreads();

  // the chunk's max and sum of each head: a warp a head
  const long long stat0 =
      ((static_cast<long long>(b) * KV + kvh) * n_chunks + c) * G;
  for (int g = warp; g < G; g += DEC_WARPS) {
    float* sr = Ss + g * chunk;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      m_out[stat0 + g] = mx;
      l_out[stat0 + g] = sum;
    }
  }
  __syncthreads();

  // accumulator: a thread a value column, DEC_GB heads a pass over v
  for (int d = tid; d < hd; d += DEC_THREADS) {
    for (int g0 = 0; g0 < G; g0 += DEC_GB) {
      float a[DEC_GB];
#pragma unroll
      for (int gg = 0; gg < DEC_GB; ++gg) a[gg] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float vv = to_f(
            v[((static_cast<long long>(b) * Tk + t0 + j) * KV + kvh) * hd
              + d]);
#pragma unroll
        for (int gg = 0; gg < DEC_GB; ++gg)
          if (g0 + gg < G) a[gg] = fmaf(Ss[(g0 + gg) * chunk + j], vv, a[gg]);
      }
#pragma unroll
      for (int gg = 0; gg < DEC_GB; ++gg)
        if (g0 + gg < G) acc_out[(stat0 + g0 + gg) * hd + d] = a[gg];
    }
  }
}

// Block (head h, batch b): merge the chunks of head h.
__global__ void __launch_bounds__(DEC_THREADS)
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
    denom += expf(m[base + c * G] - mx) * l[base + c * G];
  denom = fmaxf(denom, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += DEC_THREADS) {
    float o = 0.f;
    for (int c = 0; c < n_chunks; ++c)
      o = fmaf(expf(m[base + c * G] - mx), acc[(base + c * G) * hd + d], o);
    out[(static_cast<long long>(b) * H + h) * hd + d] = o / denom;
  }
}

template <typename T>
cudaError_t decode_launch(const void* q, const void* k, const void* v,
                          const void* valid, int B, int Tk, int H, int KV,
                          int hd, int chunk, float scale, float* m, float* l,
                          float* acc, float* out, cudaStream_t stream) {
  const int G = H / KV;
  const int n_chunks = (Tk + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * (hd + chunk);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T><<<dim3(n_chunks, KV, B), DEC_THREADS, smem,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid), Tk, H, KV,
      hd, G, chunk, n_chunks, scale, m, l, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<dim3(H, B), DEC_THREADS, 0, stream>>>(
      m, l, acc, out, H, KV, hd, G, n_chunks);
  return cudaGetLastError();
}

bool shapes_ok(int B, int H, int KV, int hd) {
  return B > 0 && KV > 0 && H % KV == 0 && hd > 0 && hd <= MAX_HEAD_DIM;
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv) -> out (B, S, H,
// hdv), all of one type (dtype 0: float, 1: bf16), contiguous.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int S, int Tk, int H,
                           int KV, int hd, int hdv, int causal, int window,
                           float softcap, float scale, void* stream) {
  if (!shapes_ok(B, H, KV, hd) || S <= 0 || Tk <= 0 || H / KV > FL_ROWS ||
      hdv <= 0 || hdv > MAX_HEAD_DIM)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_dispatch<float>(q, k, v, out, B, S, Tk, H, KV, hd, hdv,
                                 causal, window, softcap, scale, st);
  if (dtype == 1)
    return flash_dispatch<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, hd,
                                         hdv, causal, window, softcap, scale,
                                         st);
  return cudaErrorInvalidValue;
}

// q (B, H, hd), k/v (B, T, KV, hd), valid (B, T) one byte each -> out
// (B, H, hd) f32, logits scaled by scale; m/l (B, KV, chunks, G) and acc
// (B, KV, chunks, G, hd) f32 scratch, chunks = ceil(T / chunk).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, int dtype, int B, int Tk,
                            int H, int KV, int hd, int chunk, float scale,
                            void* m, void* l, void* acc, void* out,
                            void* stream) {
  if (!shapes_ok(B, H, KV, hd) || Tk <= 0 || chunk <= 0 ||
      chunk > DEC_MAX_CHUNK)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  float* of = static_cast<float*>(out);
  if (dtype == 0)
    return decode_launch<float>(q, k, v, valid, B, Tk, H, KV, hd, chunk,
                                scale, mf, lf, af, of, st);
  if (dtype == 1)
    return decode_launch<__nv_bfloat16>(q, k, v, valid, B, Tk, H, KV, hd,
                                        chunk, scale, mf, lf, af, of, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
