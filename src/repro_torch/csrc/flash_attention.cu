// Flash attention forward for Hopper (sm_90a): grouped-query attention with
// an online softmax, causal / sliding-window / per-lane length masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  Same function: q (B,S,H,dh), k/v (B,T,KV,dh), query head h
// reads KV head h / (H/KV); scores and softmax in fp32 with scale 1/sqrt(dh);
// key t is admissible for the query at absolute position qpos when
// t < kv_len[b], t <= qpos (causal) and t > qpos - window (window > 0);
// rows with no admissible key are exact zeros.  qpos = q_offset[b] + s, which
// lets the paged serving path run chunked prefill (q_offset = chunk base) and
// one-token decode (S = 1, q_offset = cached length) through this kernel.
//
// What bounds it on the H100: at the serving shapes (prefill S=128 over
// T<=512, decode S=1) attention is a small share of the FLOPs and reads each
// K/V byte once per query head, so it is bound by memory traffic and by the
// fp32 FMA rate of this first version, far from the bf16 tensor-core peak.
// The design keeps everything per tile on chip: one CTA per (64 query rows,
// head, lane); 64 x dh K and V tiles read with 16-byte loads, all of a
// thread's loads of a tile in flight at once, and staged in shared memory (as
// fp32, rows padded by one word so column reads are free of bank conflicts);
// the score tile, running max and running sum never leave shared memory; the
// output accumulator lives in registers (thread t owns column t % dh).  Tiles
// wholly outside the causal / window / length bounds are never loaded, and
// query rows past S are never computed, so one decode row costs one row.
// Products are plain FMA loops; wgmma, TMA and putting the G query heads of
// one KV head into one CTA are later work.
//
// The same body, compiled with PARTIAL = true, is ring attention's panel
// visit (flash_partial_fwd below).  It replaces the TPU kernel
// src/repro/kernels/ring_attention.py::_flash_partial (_partial_kernel): local
// q (B,S,H,dh) against one K/V panel (B,T,KV,dh), placed by the per-lane
// offset delta = q_start - k_start (the q_offset of the full kernel), and it
// writes the un-normalised online-softmax state instead of the output: acc
// (B,S,H,dh) fp32 not divided by l, the row max m and the row sum l (B,S,H)
// fp32.  A row the panel rejects whole is written as the JAX state (acc, m,
// l) = (0, -1e30, 0), so that merging two empty states never takes
// exp(-inf - -inf).  delta ranges over [-(P-1) T, (P-1) T]: a panel wholly
// ahead of the q shard (causally dead) makes the tile range empty, and with
// a window a panel far behind it starts past the panel's end; neither loads
// a tile, and the launch costs only the write of the empty state.  Bounded
// like the full kernel: at the ring's shapes (S = T = 8192 per rank) a fully
// visible visit is 1.1 TFLOP, bound by operations, and these FMA loops run
// far below the tensor cores' rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;  // the ring state's "no key" row max

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from global memory (4 floats or 8 bf16) as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

template <int DH>
constexpr size_t smem_floats() {
  // q, k (padded rows), v, scores (padded rows), running max / sum / rescale
  return BLOCK_Q * (DH + 1) + BLOCK_K * (DH + 1) + BLOCK_K * DH +
         BLOCK_Q * (BLOCK_K + 1) + 3 * BLOCK_Q;
}

// PARTIAL = false: o is the (B,S,H,dh) output in T.  PARTIAL = true: o is
// acc (B,S,H,dh) fp32, m_out and l_out are (B,S,H) fp32.
template <typename T, int DH, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 const int* __restrict__ q_offset,
                 const int* __restrict__ kv_len, int S, int T_len, int H,
                 int KV, int causal, int window, float scale) {
  static_assert(THREADS % DH == 0 || DH % THREADS == 0, "dh layout");
  constexpr int QS = DH + 1;                   // padded row stride
  constexpr int PS = BLOCK_K + 1;
  constexpr int RPT = BLOCK_Q * DH / THREADS;  // output rows per thread
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  static_assert(BLOCK_K * DH % (VEC * THREADS) == 0, "tile load layout");
  extern __shared__ float smem[];
  float* sq = smem;                            // BLOCK_Q x QS, pre-scaled
  float* sk = sq + BLOCK_Q * QS;               // BLOCK_K x QS
  float* sv = sk + BLOCK_K * QS;               // BLOCK_K x DH
  float* sp = sv + BLOCK_K * DH;               // BLOCK_Q x PS scores / probs
  float* s_m = sp + BLOCK_Q * PS;              // running max per row
  float* s_l = s_m + BLOCK_Q;                  // running sum per row
  float* s_a = s_l + BLOCK_Q;                  // this tile's rescale per row

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(BLOCK_Q, S - q0);
  const int kvh = h / (H / KV);
  const int off = q_offset ? q_offset[b] : 0;
  const int klen = max(0, min(kv_len ? kv_len[b] : T_len, T_len));

  // keys admissible to at least one row of this block: [k_lo, k_hi).  With
  // a negative offset k_hi may be negative, and with a window k_lo may pass
  // T_len; both leave the range empty.  k_lo >= 0, so k_lo / BLOCK_K below
  // never divides a negative number.
  int k_hi = klen;
  if (causal) k_hi = min(k_hi, off + q0 + rows);
  const int k_lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int kt_first = k_lo < k_hi ? (k_lo / BLOCK_K) * BLOCK_K : k_hi;

  for (int i = tid; i < rows * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    sq[r * QS + d] =
        to_float(q[((size_t)(b * S + q0 + r) * H + h) * DH + d]) * scale;
  }
  for (int r = tid; r < BLOCK_Q; r += THREADS) {
    s_m[r] = -INFINITY;
    s_l[r] = 0.f;
  }
  const int d_own = tid % DH;
  const int r_own = (tid / DH) * RPT;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int kt = kt_first; kt < k_hi; kt += BLOCK_K) {
    __syncthreads();  // the previous tile is no longer read
    // stage the K/V tile: 16-byte loads, all of a thread's in flight at once
    const int kn = min(BLOCK_K, T_len - kt);
#pragma unroll
    for (int it = 0; it < BLOCK_K * DH / VEC / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (DH / VEC), d = (i % (DH / VEC)) * VEC;
      float kx[VEC], vx[VEC];
      if (r < kn) {
        const size_t g = ((size_t)(b * T_len + kt + r) * KV + kvh) * DH + d;
        load16(k + g, kx);
        load16(v + g, vx);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sk[r * QS + d + j] = kx[j];
        sv[r * DH + d + j] = vx[j];
      }
    }
    __syncthreads();

    // scores of this tile, masked to -inf
    for (int i = tid; i < rows * BLOCK_K; i += THREADS) {
      const int r = i / BLOCK_K, c = i % BLOCK_K;
      const float* qr = sq + r * QS;
      const float* kr = sk + c * QS;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      const int qpos = off + q0 + r, kpos = kt + c;
      bool ok = kpos < klen;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      sp[r * PS + c] = ok ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per row, two columns per lane
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += THREADS / 32) {
      float* pr = sp + r * PS;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // else no admissible key yet: keep zeros
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
        alpha = expf(m_prev - m_new);
      }
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        s_m[r] = m_new;
        s_l[r] = s_l[r] * alpha + sum;
        s_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for the rows and the column this thread owns
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r_own + i;
      if (r < rows) {
        const float* pr = sp + r * PS;
        float a = acc[i] * s_a[r];
#pragma unroll 8
        for (int c = 0; c < BLOCK_K; ++c) a = fmaf(pr[c], sv[c * DH + d_own], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r_own + i;
    if (r < rows) {
      const size_t at = ((size_t)(b * S + q0 + r) * H + h) * DH + d_own;
      if constexpr (PARTIAL) {
        static_cast<float*>(o)[at] = acc[i];  // 0 on a rejected row
      } else {
        const float l = s_l[r];
        static_cast<T*>(o)[at] = from_float<T>(l > 0.f ? acc[i] / l : 0.f);
      }
    }
  }
  if constexpr (PARTIAL) {
    for (int r = tid; r < rows; r += THREADS) {
      const size_t at = (size_t)(b * S + q0 + r) * H + h;
      const float m = s_m[r];
      m_out[at] = m == -INFINITY ? NEG_INF : m;
      l_out[at] = s_l[r];
    }
  }
}

template <typename T, int DH, bool PARTIAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* m_out, float* l_out, const int* q_offset,
                   const int* kv_len, int B, int S, int T_len, int H, int KV,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH, PARTIAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  flash_fwd_kernel<T, DH, PARTIAL><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, m_out, l_out, q_offset, kv_len, S, T_len,
      H, KV, causal, window, scale);
  return cudaGetLastError();
}

template <bool PARTIAL>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* m_out, float* l_out, const void* q_offset,
             const void* kv_len, int B, int S, int T_len, int H, int KV,
             int dh, int dtype, int causal, int window, float scale,
             void* stream) {
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128, PARTIAL>(q, k, v, o, m_out, l_out, qo,
                                                kl, B, S, T_len, H, KV,
                                                causal, window, scale, st);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64, PARTIAL>(q, k, v, o, m_out, l_out, qo,
                                               kl, B, S, T_len, H, KV, causal,
                                               window, scale, st);
  if (dtype == 0 && dh == 128)
    return launch<float, 128, PARTIAL>(q, k, v, o, m_out, l_out, qo, kl, B,
                                       S, T_len, H, KV, causal, window,
                                       scale, st);
  if (dtype == 0 && dh == 64)
    return launch<float, 64, PARTIAL>(q, k, v, o, m_out, l_out, qo, kl, B, S,
                                      T_len, H, KV, causal, window, scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q_offset / kv_len: int32 (B,) device
// pointers or null.  window <= 0 means no window.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* q_offset, const void* kv_len,
                                   int B, int S, int T_len, int H, int KV,
                                   int dh, int dtype, int causal, int window,
                                   float scale, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, q_offset, kv_len, B, S,
                         T_len, H, KV, dh, dtype, causal, window, scale,
                         stream);
}

// Ring attention's panel visit: acc (B,S,H,dh), m and l (B,S,H) fp32
// outputs; delta: int32 (B,) device pointer, q_start - k_start for every
// lane.  Other arguments as above; the panel has no length mask.
extern "C" int flash_partial_fwd(const void* q, const void* k, const void* v,
                                 void* acc, void* m, void* l,
                                 const void* delta, int B, int S, int T_len,
                                 int H, int KV, int dh, int dtype, int causal,
                                 int window, float scale, void* stream) {
  return dispatch<true>(q, k, v, acc, static_cast<float*>(m),
                        static_cast<float*>(l), delta, nullptr, B, S, T_len,
                        H, KV, dh, dtype, causal, window, scale, stream);
}
