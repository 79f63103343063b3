// Flash attention for Hopper (sm_90a): grouped-query attention with an
// online softmax, causal / sliding-window / per-lane length masks; forward,
// and the training path's backward.
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
// The same body, compiled with PARTIAL = true, is ring attention's panel
// visit (flash_partial_fwd below).  It replaces the TPU kernel
// src/repro/kernels/ring_attention.py::_flash_partial (_partial_kernel): local
// q (B,S,H,dh) against one K/V panel (B,T,KV,dh), placed by the per-lane
// offset delta = q_start - k_start (the q_offset of the full kernel), and it
// writes the un-normalised online-softmax state instead of the output: acc
// (B,S,H,dh) fp32 not divided by l, the row max m (natural-log units of the
// scaled scores) and the row sum l (B,S,H) fp32.  A row the panel rejects
// whole is written as the JAX state (acc, m, l) = (0, -1e30, 0), so that
// merging two empty states never takes exp(-inf - -inf).  delta ranges over
// [-(P-1) T, (P-1) T]: a panel wholly ahead of the q shard (causally dead)
// makes the tile range empty, and with a window a panel far behind it starts
// past the panel's end; neither loads a tile, and the launch costs only the
// write of the empty state.
//
// Two bodies, chosen by dtype; both are hand-written and a failed launch
// raises in the wrapper.
//
// bf16 (flash_fwd_wgmma_kernel): tensor cores.  What bounds it on the H100:
// a fully visible ring visit (S = T = 8192, H 32, KV 8, dh 128) is 1.1 TFLOP
// of products, bound by operations; serving's prefill chunk and decode step
// are bound by bytes (each K/V byte should be read once) and by latency.
// The design:
//  - Packed GQA rows.  One CTA (one warpgroup, 128 threads) owns one (lane b,
//    KV head) and 64 packed rows: row m is query position s = m / G of head
//    kvh * G + m % G, G = H / KV.  Each K/V tile is read once for its G heads,
//    and a decode CTA (S = 1) holds G real rows instead of 1.  Grid
//    ceil(S G / 64) x KV x B; any G works.  The masks use s, and the tile
//    range [k_lo, k_hi) is cut from the CTA's first and last s.
//  - Q is staged once in shared memory in the 128-byte-swizzled K-major
//    layout that the wgmma descriptor names (rows of 64 bf16, 16-byte chunk
//    c of row r at chunk c ^ (r % 8); dh 128 is two such column blocks).
//  - K/V tiles of 64 keys arrive by TMA (a 4-D tensor map over the
//    contiguous (dh, KV, T, B) array, boxes of 64 dh x 64 keys, 128-byte
//    swizzle, rows past T zero-filled) into a ring of two stages with
//    mbarrier completion; the loads of tile j + 1 are in flight while tile j
//    is computed.
//  - S = Q K^T by wgmma m64n64k16 (bf16 in, fp32 accumulate; both operands
//    from shared memory, K K-major).  bf16 x bf16 products are exact in
//    fp32, so S is the reference's fp32 q k^T up to summation order.
//  - Online softmax on the accumulator fragment: a thread holds 2 rows x 16
//    keys; row max by two quad shuffles; exp2 with the scale folded in (m is
//    written back in natural-log units); masks only on tiles that cross a
//    bound; l summed per thread in fp32 and over the quad at the end.
//  - acc += P V by wgmma m64n{dh}k16 with P from registers (the S fragment
//    repacked to bf16 pairs is exactly the A fragment) and V from shared
//    memory, dh-contiguous (MN-major, transpose bit set).  The reference
//    multiplies V by fp32 P; rounding P to bf16 moves acc by about 1.5e-3
//    of its largest magnitude at the ring's 8192-key visible visit
//    (chip_smoke.py phase 2 measures it), against a 2e-3 tolerance.  So P
//    is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two wgmma into
//    the same fp32 accumulator: V is exact in bf16, so the error falls to
//    about 2^-16 of P, for 1.5x the MMA work.
//  - The epilogue divides by l and writes bf16 (rows with l = 0 as exact
//    zeros), or with PARTIAL writes acc undivided with m and l, each at
//    (b, s, kvh * G + g).
// Left for later: warp specialisation (a producer warp and setmaxnreg),
// overlapping one tile's softmax with the next tile's Q K^T, persistent CTAs.
//
// Head dims.  The TPU kernel takes any dh (its blocks span the whole row);
// this file instantiates the ones the port's configs use: 64, 128, and 112
// (kimi-k2-1t-a32b: 7168 / 64).  The bf16 bodies assume rows of whole
// 128-byte swizzle atoms (64 bf16), and 112 = 64 + 48 is not, so dh 112
// runs in tiles padded to DP = pad64(DH) = 128 columns inside the kernel,
// over tensor maps of the real 112-wide arrays: the second 64-column box of
// a row reads the 48 real columns and the TMA zero-fills the 16 past the
// end (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE; the box's bytes still count in
// full on the mbarrier), Q is staged by the threads with zeros in its pad
// columns, and a row's global stride is the real 224 bytes, which TMA
// takes (a multiple of 16).  Products over dh (Q K^T, dO V^T) run dh / 16
// = 7 k-steps and never read the pad; products whose N is dh (P V, dS K,
// P^T dO, dS^T Q) run at N = DP with operands whose pad columns are zeros,
// so the accumulator's pad columns stay 0 and the epilogues store only the
// DH real ones.  The scale stays 1 / sqrt(dh) from the wrapper.  The other
// way, a wgmma of N = 112 (legal), would need 112-column MN-major operand
// descriptors across a partial swizzle atom; padding keeps one tile layout
// for every dh at the price of 128 / 112 of the N = dh products' work.
// The fp32 FMA bodies take dh 112 as it is, with the threads that own a
// column past 112 idle in the products and the stores.
//
// fp32 (flash_fwd_kernel): the first version's FMA body, unchanged.  Its job
// is exactness (the fp32 cases within 1e-5, fp32 greedy tokens identical card
// against CPU); TF32 tensor cores would break both.  One CTA per (64 query
// rows, head, lane); 64 x dh K and V tiles read with 16-byte loads and staged
// in shared memory as fp32 (rows padded by one word), scores and the running
// max / sum in shared memory, the output accumulator in registers.
//
// Both forward bodies also write the row log-sum-exp lse = m + log l of the
// scaled scores (natural-log units; +inf on a row with no admissible key)
// when given a buffer for it: the training path's forward does, for the
// backward; serving passes none and writes nothing more.
//
// Backward (flash_attention_bwd below).  The TPU package has no backward
// kernel (the JAX package trains through autodiffed jnp attention); this one
// computes the gradients of the same function for the training path's masks
// (no offsets or lengths; self-attention, S == T, causal or not, with or
// without a window; cross-attention, S queries against T != S keys with no
// mask), for both dtypes, with fp32 accumulators:
//   P = exp(scale Q K^T - lse) on admissible pairs, D = rowsum(dO o O),
//   dV = P^T dO, dP = dO V^T, dS = P o (dP - D),
//   dQ = scale dS K, dK = scale dS^T Q,
// dK and dV summed over the G query heads of each KV head.  What bounds it
// on the H100: at qwen3-4b's training shape (B 2, S 4096, H 32, KV 8, dh
// 128, causal) the five products (S, dP, dV, dK, dQ) are about 0.69 TFLOP,
// bound by operations: 0.695 ms at 989 TFLOP/s.  The design:
//  - Three kernels, no atomics: D (one warp a row); dK/dV (a CTA per key
//    tile, KV head and lane loops over the G heads of its group and the
//    query tiles the masks admit for its keys, then writes dK and dV once);
//    dQ (a CTA per query tile, head and lane loops over the key tiles its
//    rows admit).  Every output is written by one thread in a fixed order,
//    so dq, dk and dv are the same bits on every run.  The price: S and dP
//    are computed in both kernels, seven products where five are needed.
//    One kernel could run five, but it would sum dQ over the key-tile CTAs
//    by fp32 atomics, whose order, and so whose bits, change from run to
//    run (ROADMAP K9 keeps it as a later option, with ordered dQ).
//  - bf16 (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel): warp
//    specialised, the products on wgmma.  A CTA of 288 threads: a producer
//    warp issues TMA loads into a ring of three stages with full / empty
//    mbarriers, so the next tiles are in flight during the products; two
//    consumer warpgroups compute.  Stationary operands are loaded once
//    (dK/dV: the CTA's 64 keys of K and V; dQ: each consumer's 64 query
//    rows of Q and dO); the other pair streams in 64-row tiles.  The
//    register budget shapes the split: nine warps put three on one of the
//    SM's four register partitions, which caps a thread at 168 registers,
//    and ptxas keeps that cap whatever setmaxnreg asks (measured: a
//    producer warpgroup at 24 with consumers at 240 compiled to 168 and
//    spilled).  So no consumer holds more than one 64 x dh accumulator.
//  - dK/dV computes the products transposed (FlashAttention-3's swap of A
//    and B) and splits them between its consumers: warpgroup 0 computes
//    S^T = K Q^T, P^T on the fragment (lse per column, staged per tile by
//    the producer warp) and dV += P^T dO; warpgroup 1 computes
//    dP^T = V dO^T, dS^T = P^T o (dP^T - D) with P^T handed over in shared
//    memory (each thread's fragment to the same thread of warpgroup 1), and
//    dK += dS^T Q.  P^T and dS^T are register A fragments of the two last
//    products.  dQ: S = Q K^T and dP = dO V^T, dS on the fragment,
//    dQ += dS K; P is formed while dP is computed.  A consumer skips a
//    64 x 64 block the masks reject whole and masks per element only a
//    block that crosses a bound.
//  - P and dS enter dV, dK and dQ rounded to bf16 (the tensor cores' input
//    type), where the forward splits P into bf16 hi + lo.  chip_smoke.py
//    phase 2 measures why: at the training shape the plain arithmetic with
//    P and dS rounded moves dq, dk and dv by 2.69e-03, 1.83e-03 and
//    1.21e-03 of their largest magnitudes against fp32 P and dS (split:
//    3.57e-06, 6.91e-06, 5.95e-06; NVIDIA H100 80GB HBM3, 700 W), within
//    half the bf16 tolerance of 2e-2; splitting would double the three
//    products (ten passes where rounding runs seven).
//  - fp32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): FMA loops, for
//    exactness as in the forward.  Tiles of 64 staged in shared memory
//    (rows padded by 4 words, float4 reads along dh); the score stage gives
//    each thread a 4 x 4 register tile of S and dP; P and dS meet the other
//    products through shared memory; dK/dV and dQ are register tiles of 4
//    rows x dh / 16 columns.
//  - Causal load balance: the dK/dV grid starts at the first key tile and
//    the dQ grid at the last query tile, the CTAs with the most work.
//  - Cross-attention (S != T, whisper's decoder: 448 queries over 1500
//    encoder keys) runs the same bodies with the two lengths apart: the
//    dK/dV grid covers ceil(T / 64) key tiles and loops over the query
//    tiles of S, the dQ grid covers the query tiles of S and loops over
//    ceil(T / 64) key tiles; the bf16 tensor maps of k and v hold T rows,
//    those of q and dout S.  Both sides may be ragged at once (1500 = 23 x
//    64 + 28): TMA zero-fills the rows past T (or S) of a tile and still
//    counts the whole box on the mbarrier, a block that crosses either end
//    is masked per element (keys at or past T, queries at or past S), and
//    dQ stores no row at or past S, dK and dV none at or past T.  At
//    S == T every bound is the one the self-attention path always used, so
//    its bits do not change.  The reference differentiates cross-attention
//    only without a mask, so causal or windowed attention at S != T is
//    refused (cudaErrorInvalidValue).  Bound at whisper-medium's shape (B
//    8, S 448, T 1500, H = KV = 16, dh 64): 10 x 5.376e6 pairs x 16 x 64 =
//    55.1 GFLOP, 0.0557 ms at 989 TFLOP/s.
// Left for later (ROADMAP K9): the fused five-product kernel with dQ summed
// in a fixed order (a semaphore per query tile), persistent CTAs, and
// overlapping a consumer's elementwise work with its own next product.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;  // the ring state's "no key" row max

// a head's row padded to whole 64-column blocks (the note at the top)
__host__ __device__ constexpr int pad64(int dh) {
  return (dh + 63) / 64 * 64;
}

// ---------------------------------------------------------------------------
// fp32: the FMA body
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// 16 bytes of fp32 from global memory (4 values) as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int DH>
constexpr size_t smem_floats() {
  // q, k (padded rows), v, scores (padded rows), running max / sum / rescale
  return BLOCK_Q * (DH + 1) + BLOCK_K * (DH + 1) + BLOCK_K * DH +
         BLOCK_Q * (BLOCK_K + 1) + 3 * BLOCK_Q;
}

// PARTIAL = false: o is the (B,S,H,dh) output in T, and m_out, if not
// null, the (B,S,H) fp32 row log-sum-exp (+inf on a row with no admissible
// key).  PARTIAL = true: o is acc (B,S,H,dh) fp32, m_out and l_out are
// (B,S,H) fp32.
template <typename T, int DH, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 const int* __restrict__ q_offset,
                 const int* __restrict__ kv_len, int S, int T_len, int H,
                 int KV, int causal, int window, float scale) {
  // thread tid owns output column tid % DP (idle past DH: dh 112)
  constexpr int DP = pad64(DH);
  static_assert(THREADS % DP == 0 || DP % THREADS == 0, "dh layout");
  constexpr int QS = DH + 1;                   // padded row stride
  constexpr int PS = BLOCK_K + 1;
  constexpr int RPT = BLOCK_Q * DP / THREADS;  // output rows per thread
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
  const int d_own = tid % DP;
  const int r_own = (tid / DP) * RPT;
  const bool owns = DH == DP || d_own < DH;
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
      if (owns && r < rows) {
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
    if (owns && r < rows) {
      const size_t at = ((size_t)(b * S + q0 + r) * H + h) * DH + d_own;
      if constexpr (PARTIAL) {
        static_cast<float*>(o)[at] = acc[i];  // 0 on a rejected row
      } else {
        const float l = s_l[r];
        static_cast<T*>(o)[at] = from_float<T>(l > 0.f ? acc[i] / l : 0.f);
      }
    }
  }
  if (PARTIAL || m_out != nullptr) {
    for (int r = tid; r < rows; r += THREADS) {
      const size_t at = (size_t)(b * S + q0 + r) * H + h;
      const float m = s_m[r], l = s_l[r];
      if constexpr (PARTIAL) {
        m_out[at] = m == -INFINITY ? NEG_INF : m;
        l_out[at] = l;
      } else {  // sq is pre-scaled: m and l are in natural-log units
        m_out[at] = l > 0.f ? m + logf(l) : INFINITY;
      }
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

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int ROWS = 64;     // packed rows per CTA: one warpgroup's wgmma M
constexpr int KEYS = 64;     // keys per K/V tile: the wgmma N of S = Q K^T
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int SW_BYTES = 128;          // one swizzled row: 64 bf16
constexpr int SW_COLS = SW_BYTES / 2;

template <int DH>
struct Layout {
  // offsets from the 1024-byte-aligned base: every tile starts on a
  // swizzle atom (8 rows x 128 bytes)
  static constexpr int Q_BYTES = ROWS * DH * 2;
  static constexpr int TILE_BYTES = KEYS * DH * 2;  // one K or V tile
  static constexpr int KV_OFF = Q_BYTES;             // + stage * 2 tiles
  static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * TILE_BYTES;
  static constexpr int BYTES = BAR_OFF + STAGES * 8 + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for a stage's phase; a tile that has not arrived after 10 s traps
// (the launch then fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// one box of the 4-D tensor map {dh, KV, T, B} into shared memory,
// completing on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t),
      "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of a wgmma's registers
// across the volatile wgmma asm around it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D32                                \
  "{"                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "          \
  "%8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, "  \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64                                \
  "{"                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "          \
  "%8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, "  \
  "%24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, "  \
  "%40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_F8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d) WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
#define WG_F64(d) WG_F32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), \
                  WG_F8(d, 56)

// d (64 x 64 fp32) = (accumulate ? d : 0) + A B, A (64 x 16) and B (16 x 64)
// bf16 from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F32(d)
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// d (64 x N fp32) += A B, A (64 x 16) bf16 from registers, B (16 x N) bf16
// from shared memory, MN-major (transpose bit set)
template <int N>
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_tn<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_rs_tn<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Tensor maps of k and v, encoded on the host for each call.  PARTIAL, and
// m_out as the row log-sum-exp when PARTIAL is false, as in
// flash_fwd_kernel.
template <int DH, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __nv_bfloat16* __restrict__ q,
                       void* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ kv_len, int S, int T_len,
                       int H, int KV, int causal, int window, float scale) {
  constexpr int DP = pad64(DH);     // the tiles' padded row
  static_assert(DH % 16 == 0, "Q K^T runs dh / 16 k-steps");
  using L = Layout<DP>;
  constexpr int CB = DP / SW_COLS;  // 128-byte column blocks of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + L::BAR_OFF;  // stage st: bar0 + 8 st

  const int tid = threadIdx.x;
  const int G = H / KV;
  const int m0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = S * G;                 // packed rows of (b, kvh)
  const int s_first = m0 / G;
  const int s_last = (min(m0 + ROWS, n_rows) - 1) / G;
  const int off = q_offset ? q_offset[b] : 0;
  const int klen = max(0, min(kv_len ? kv_len[b] : T_len, T_len));

  // keys admissible to at least one row of this CTA: [k_lo, k_hi), cut as
  // in flash_fwd_kernel from the first and last query position
  int k_hi = klen;
  if (causal) k_hi = min(k_hi, off + s_last + 1);
  const int k_lo = window > 0 ? max(0, off + s_first - window + 1) : 0;
  const int kt_first = (k_lo / KEYS) * KEYS;
  const int n_tiles = k_lo < k_hi ? (k_hi - kt_first + KEYS - 1) / KEYS : 0;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // thread 0 only: tile j into stage j % STAGES, K then V, one box per
  // 64-wide column block
  auto load_tile = [&](int j) {
    const int st = j % STAGES;
    const uint32_t bar = bar0 + 8 * st;
    const uint32_t kdst = base + L::KV_OFF + st * 2 * L::TILE_BYTES;
    const int kt = kt_first + j * KEYS;
    mbar_expect_tx(bar, 2 * L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      tma_load(kdst + c * KEYS * SW_BYTES, &tm_k, bar, c * SW_COLS, kvh, kt,
               b);
      tma_load(kdst + L::TILE_BYTES + c * KEYS * SW_BYTES, &tm_v, bar,
               c * SW_COLS, kvh, kt, b);
    }
  };
  if (tid == 0)
    for (int j = 0; j < min(n_tiles, STAGES); ++j) load_tile(j);

  // stage Q: packed row r at (s, h) = ((m0 + r) / G, kvh G + (m0 + r) % G);
  // rows past S G and columns past DH are zeros.  A dead CTA skips it.
  if (n_tiles > 0) {
    for (int i = tid; i < ROWS * DP / 8; i += THREADS) {
      const int r = i / (DP / 8), c = i % (DP / 8);
      const int m = m0 + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (m < n_rows && c < DH / 8)
        x = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * S + m / G) * H + kvh * G + m % G) * DH + c * 8);
      *reinterpret_cast<uint4*>(smem + (c / 8) * ROWS * SW_BYTES +
                                r * SW_BYTES + (((c % 8) ^ (r % 8)) << 4)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // accumulator fragment: warp w, lane = 4 g + tq holds rows r0 = 16 w + g
  // and r1 = r0 + 8; element i is row (i >> 1) & 1, column
  // 8 (i / 4) + 2 tq + (i & 1)
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;
  const int r0 = 16 * warp + lane / 4;
  const int qpos[2] = {off + (m0 + r0) / G, off + (m0 + r0 + 8) / G};
  const float c2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  float acc[DP / 2];
  float s[KEYS / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) s[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // raw q.k units
  float l_run[2] = {0.f, 0.f};              // this thread's columns only

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const int kt = kt_first + j * KEYS;
    const uint32_t kbase = base + L::KV_OFF + st * 2 * L::TILE_BYTES;
    const uint32_t vbase = kbase + L::TILE_BYTES;
    mbar_wait(bar0 + 8 * st, (j / STAGES) & 1);

    // S = Q K^T over dh in steps of 16: 32 bytes along a swizzled row (the
    // pad columns of dh 112 are never read)
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t col = (kk / 4) * SW_BYTES, step = (kk % 4) * 32;
      wgmma_ss_n64(s,
                   sw128_desc(base + col * ROWS + step, 16, 8 * SW_BYTES),
                   sw128_desc(kbase + col * KEYS + step, 16, 8 * SW_BYTES),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    const bool masked = kt + KEYS > klen ||
                        (causal && kt + KEYS - 1 > off + s_first) ||
                        (window > 0 && kt <= off + s_last - window);
    if (masked) {
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int kpos = kt + 8 * (i / 4) + 2 * tq + (i & 1);
        const int qp = qpos[(i >> 1) & 1];
        bool ok = kpos < klen;
        if (causal) ok = ok && kpos <= qp;
        if (window > 0) ok = ok && kpos > qp - window;
        if (!ok) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float ms[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // no admissible key yet: p = exp2(-inf) = 0, never -inf - -inf
      ms[r] = m_new == -INFINITY ? 0.f : m_new * c2;
      alpha[r] = fast_exp2(m_run[r] * c2 - ms[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      s[i] = fast_exp2(fmaf(s[i], c2, -ms[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P as A fragments, split into bf16 high and low parts: for keys
    // 16 kk .. 16 kk + 15, register e holds elements 8 kk + 2 e, + 1
    uint32_t p_hi[KEYS / 16][4], p_lo[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = s[8 * kk + 2 * e], x1 = s[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][e] = bf16x2_bits(hi);
        p_lo[kk][e] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
    }
    // acc += P_hi V + P_lo V; keys 16 kk.. are rows 16 kk.. of the V tile,
    // at N = DP (V's pad columns are zeros, and so are acc's)
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint64_t dv = sw128_desc(vbase + kk * 16 * SW_BYTES,
                                     KEYS * SW_BYTES, 8 * SW_BYTES);
      wgmma_rs_tn<DP>(acc, p_hi[kk], dv);
      wgmma_rs_tn<DP>(acc, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + STAGES < n_tiles) load_tile(j + STAGES);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + r0 + 8 * r;
    if (m >= n_rows) continue;
    const size_t row = ((size_t)b * S + m / G) * H + kvh * G + m % G;
    if constexpr (PARTIAL) {
      float* out = static_cast<float*>(o) + row * DH + 2 * tq;
#pragma unroll
      for (int jn = 0; jn < DH / 8; ++jn)  // 0 on a rejected row; real columns
        *reinterpret_cast<float2*>(out + 8 * jn) =
            make_float2(acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
      if (tq == 0) {
        m_out[row] = m_run[r] == -INFINITY ? NEG_INF : m_run[r] * scale;
        l_out[row] = l_run[r];
      }
    } else {
      // l is a sum of exp2((s - m) scale log2 e) = exp(scale (s - m)), so
      // the natural-log row log-sum-exp is scale m + log l
      if (m_out != nullptr && tq == 0)
        m_out[row] = l_run[r] > 0.f ? m_run[r] * scale + logf(l_run[r])
                                    : INFINITY;
      const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o) + row * DH + 2 * tq;
#pragma unroll
      for (int jn = 0; jn < DH / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jn) =
            __floats2bfloat162_rn(acc[4 * jn + 2 * r] * inv,
                                  acc[4 * jn + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the contiguous (B,T,KV,dh) bf16 array as a 4-D map {dh, KV, T, B}, boxes
// of 64 dh x 1 x KEYS x 1, 128-byte swizzle, rows past T and columns past dh
// (dh 112's second box) read as zeros (the backward also maps q and dout,
// with H heads for KV).  T = 0 gives a zeroed map that the kernel never
// reads (no tiles).
cudaError_t kv_map(CUtensorMap* map, const void* ptr, int B, int T_len,
                   int KV, int dh) {
  memset(map, 0, sizeof(*map));
  if (T_len == 0) return cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)dh * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)KV,
                              (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * KV, row * KV * T_len};
  const cuuint32_t box[4] = {SW_COLS, 1, KEYS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH, bool PARTIAL>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* m_out, float* l_out,
                         const int* q_offset, const int* kv_len, int B, int S,
                         int T_len, int H, int KV, int causal, int window,
                         float scale, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  cudaError_t err = kv_map(&tm_k, k, B, T_len, KV, DH);
  if (err == cudaSuccess) err = kv_map(&tm_v, v, B, T_len, KV, DH);
  if (err != cudaSuccess) return err;
  const int smem = Layout<pad64(DH)>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DH, PARTIAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * (H / KV) + ROWS - 1) / ROWS, KV, B);
  flash_fwd_wgmma_kernel<DH, PARTIAL><<<grid, THREADS, smem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), o, m_out, l_out,
      q_offset, kv_len, S, T_len, H, KV, causal, window, scale);
  return cudaGetLastError();
}

// run(std::integral_constant<int, dh>()) for a head dim and dtype (0 =
// float32, 1 = bfloat16) the kernels take; cudaErrorInvalidValue otherwise
template <typename Run>
int with_head_dim(int dh, int dtype, Run run) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64: return run(std::integral_constant<int, 64>());
    case 112: return run(std::integral_constant<int, 112>());
    case 128: return run(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
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
  auto run = [&](auto dh_c) -> int {
    constexpr int DH = decltype(dh_c)::value;
    if (dtype == 1)
      return launch_wgmma<DH, PARTIAL>(q, k, v, o, m_out, l_out, qo, kl, B, S,
                                       T_len, H, KV, causal, window, scale,
                                       st);
    return launch<float, DH, PARTIAL>(q, k, v, o, m_out, l_out, qo, kl, B, S,
                                      T_len, H, KV, causal, window, scale,
                                      st);
  };
  return with_head_dim(dh, dtype, run);
}


// ---------------------------------------------------------------------------
// backward: D, then dK/dV and dQ in two kernels without atomics
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int BWD_TILE = 64;           // query rows and keys of a tile
constexpr int BWD_PS = BWD_TILE + 16;  // row stride of the P and dS tiles

template <int DH>
struct BwdLayout {
  static constexpr int RS = DH + 4;  // row stride of a (64, DH) tile
  static constexpr int TILE = BWD_TILE * RS;
  static constexpr int PT = BWD_TILE * BWD_PS;
  // Q, dO, K and V tiles, the P and dS tiles, lse and D of the query rows
  static constexpr size_t BYTES =
      (4 * TILE + 2 * PT + 2 * BWD_TILE) * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float at4(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// whether the 4 columns 64 u + 4 td of the fp32 backward's register tiles
// lie below DH (always, unless DH is ragged: dh 112)
template <int DH>
__device__ __forceinline__ bool has_col(int u, int td) {
  return DH % 64 == 0 || 64 * u + 4 * td < DH;
}

// rows [r0, r0 + 64) of one head of a contiguous (B, n, heads, DH) fp32
// array into shared memory with row stride RS; rows at or past n are
// zeros.  Every 16-byte load of a thread is issued before its stores.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int n, int heads,
                                          int head) {
  constexpr int VEC = 4;
  constexpr int RS = DH + 4;
  constexpr int ITERS = BWD_TILE * DH / VEC / BWD_THREADS;
  static_assert(BWD_TILE * DH % (VEC * BWD_THREADS) == 0, "tile layout");
  float x[ITERS][VEC];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * BWD_THREADS;
    const int r = i / (DH / VEC), d = (i % (DH / VEC)) * VEC;
    if (r0 + r < n) {
      load16(src + (((size_t)b * n + r0 + r) * heads + head) * DH + d, x[it]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[it][j] = 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * BWD_THREADS;
    const int r = i / (DH / VEC), d = (i % (DH / VEC)) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(dst + r * RS + d + j) =
          make_float4(x[it][j], x[it][j + 1], x[it][j + 2], x[it][j + 3]);
  }
}

// lse and D of query rows [q0, q0 + 64) of head h; rows past S get 0 (the
// masks zero their P)
__device__ __forceinline__ void load_row_stats(float* slse, float* sdelta,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int b, int q0, int S, int H,
                                               int h) {
  const int r = threadIdx.x;
  if (r < BWD_TILE) {
    const bool in = q0 + r < S;
    const size_t at = ((size_t)b * S + q0 + r) * H + h;
    slse[r] = in ? lse[at] : 0.f;
    sdelta[r] = in ? delta[at] : 0.f;
  }
}

// The thread's 4 x 4 entries (query row i = ty + 16 a, key j = tx + 16 c) of
// one 64 x 64 tile pair: s = Q K^T and dp = dO V^T, dh-long fp32 dots read
// from shared memory four columns at a time
template <int DH>
__device__ __forceinline__ void score_tiles(const float* sq, const float* sdo,
                                            const float* sk, const float* sv,
                                            int tx, int ty, float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int RS = DH + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = ld4(sq + (ty + 16 * a) * RS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = ld4(sk + (tx + 16 * c) * RS + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dot4(x[a], y[c], s[a][c]);
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = ld4(sdo + (ty + 16 * a) * RS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = ld4(sv + (tx + 16 * c) * RS + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[a][c] = dot4(x[a], y[c], dp[a][c]);
  }
}

// P = exp(scale s - lse) on the admissible (query, key) pairs of the tile at
// (q0, k0) and 0 elsewhere; dS = P (dp - D).  Writes dS, and P when sp is
// not null, at [i][j] with row stride BWD_PS.  The mask is the forward's
// with no offset or length over S queries and T keys (causal or a window
// only at S == T).
__device__ __forceinline__ void softmax_grad_tiles(
    const float (&s)[4][4], const float (&dp)[4][4], const float* slse,
    const float* sdelta, float* sp, float* sds, int tx, int ty, int q0,
    int k0, int S, int T, int causal, int window, float scale) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a, qpos = q0 + i;
    const float lse = slse[i], dlt = sdelta[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c, kpos = k0 + j;
      bool ok = qpos < S && kpos < T;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float p = ok ? expf(fmaf(s[a][c], scale, -lse)) : 0.f;
      if (sp != nullptr) sp[i * BWD_PS + j] = p;
      sds[i * BWD_PS + j] = p * (dp[a][c] - dlt);
    }
  }
}

// D = rowsum(dO o O) in fp32, one warp a (b, s, h) row
template <typename T, int DH>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (BWD_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * DH;
  const T* drow = dout + (size_t)row * DH;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

// fp32: dK and dV of one 64-key tile of KV head kvh, lane b: the G query
// heads of the group and every query tile the masks admit for these keys,
// summed in the CTA's registers and written once.  Thread (tj, td) owns
// keys 4 tj + c and columns 64 u + 4 td + e (below DH: at dh 112 the
// threads with td >= 12 have no column of the second block).
template <int DH>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int T, int H, int KV,
                      int causal, int window, float scale) {
  using L = BwdLayout<DH>;
  constexpr int RS = L::RS, U = pad64(DH) / 64;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + L::TILE;
  float* sq = sv + L::TILE;
  float* sdo = sq + L::TILE;
  float* sp = sdo + L::TILE;
  float* sds = sp + L::PT;
  float* slse = sds + L::PT;
  float* sdelta = slse + BWD_TILE;

  const int k0 = blockIdx.x * BWD_TILE;  // tile 0, the most work, first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // score stage
  const int td = tid % 16, tj = tid / 16;  // dK/dV stage

  // query rows that admit a key of [k0, k0 + 64): causal q >= k0; window
  // q < k + window for the tile's last key
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BWD_TILE - 1 + window) : S;

  load_tile<DH>(sk, k, b, k0, T, KV, kvh);
  load_tile<DH>(sv, v, b, k0, T, KV, kvh);

  float dk_acc[4][4 * U], dv_acc[4][4 * U];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4 * U; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_first; q0 < q_end; q0 += BWD_TILE) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_tile<DH>(sq, q, b, q0, S, H, h);
      load_tile<DH>(sdo, dout, b, q0, S, H, h);
      load_row_stats(slse, sdelta, lse, delta, b, q0, S, H, h);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<DH>(sq, sdo, sk, sv, tx, ty, s, dp);
      softmax_grad_tiles(s, dp, slse, sdelta, sp, sds, tx, ty, q0, k0, S, T,
                         causal, window, scale);
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 query rows
#pragma unroll 2
      for (int i = 0; i < BWD_TILE; ++i) {
        const float4 p4 = ld4(sp + i * BWD_PS + 4 * tj);
        const float4 ds4 = ld4(sds + i * BWD_PS + 4 * tj);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!has_col<DH>(u, td)) continue;
          const float4 o4 = ld4(sdo + i * RS + 64 * u + 4 * td);
          const float4 q4 = ld4(sq + i * RS + 64 * u + 4 * td);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float pc = at4(p4, c), dsc = at4(ds4, c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[c][4 * u + e] = fmaf(pc, at4(o4, e), dv_acc[c][4 * u + e]);
              dk_acc[c][4 * u + e] = fmaf(dsc, at4(q4, e), dk_acc[c][4 * u + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int t = k0 + 4 * tj + c;
    if (t >= T) continue;
    const size_t row = ((size_t)b * T + t) * KV + kvh;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!has_col<DH>(u, td)) continue;
        const size_t at = row * DH + 64 * u + 4 * td + e;
        dk[at] = dk_acc[c][4 * u + e] * scale;
        dv[at] = dv_acc[c][4 * u + e];
      }
  }
}

// fp32: dQ of one 64-row query tile of head h, lane b: every key tile the
// masks admit, P and dP recomputed.  Thread (ti, td) owns rows ti + 16 a
// and columns 64 u + 4 td + e below DH, as in flash_bwd_dkdv_kernel.
template <int DH>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int T, int H, int KV, int causal, int window,
                    float scale) {
  using L = BwdLayout<DH>;
  constexpr int RS = L::RS, U = pad64(DH) / 64;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + L::TILE;
  float* sq = sv + L::TILE;
  float* sdo = sq + L::TILE;
  float* sds = sdo + L::TILE;   // (the P tile's room is unused here)
  float* slse = sds + 2 * L::PT;
  float* sdelta = slse + BWD_TILE;

  // causal: the last query tile has the most keys, so it runs first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // score stage
  const int td = tid % 16, ti = tid / 16;  // dQ stage

  // keys admissible to a row of [q0, q0 + 64): causal k <= q; window
  // k > q - window for the tile's first row
  const int k_end = causal ? min(T, q0 + BWD_TILE) : T;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_lo / BWD_TILE) * BWD_TILE;

  load_tile<DH>(sq, q, b, q0, S, H, h);
  load_tile<DH>(sdo, dout, b, q0, S, H, h);
  load_row_stats(slse, sdelta, lse, delta, b, q0, S, H, h);

  float dq_acc[4][4 * U];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4 * U; ++e) dq_acc[a][e] = 0.f;

  for (int k0 = k_first; k0 < k_end; k0 += BWD_TILE) {
    __syncthreads();  // the previous tile's K and dS are read
    load_tile<DH>(sk, k, b, k0, T, KV, kvh);
    load_tile<DH>(sv, v, b, k0, T, KV, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DH>(sq, sdo, sk, sv, tx, ty, s, dp);
    softmax_grad_tiles(s, dp, slse, sdelta, nullptr, sds, tx, ty, q0, k0, S,
                       T, causal, window, scale);
    __syncthreads();

    // dQ += dS K over the tile's 64 keys, four at a time
#pragma unroll 1
    for (int j = 0; j < BWD_TILE; j += 4) {
      float4 ds4[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds4[a] = ld4(sds + (ti + 16 * a) * BWD_PS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!has_col<DH>(u, td)) continue;
          const float4 k4 = ld4(sk + (j + jj) * RS + 64 * u + 4 * td);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float dsa = at4(ds4[a], jj);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dq_acc[a][4 * u + e] = fmaf(dsa, at4(k4, e), dq_acc[a][4 * u + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int srow = q0 + ti + 16 * a;
    if (srow >= S) continue;
    const size_t row = ((size_t)b * S + srow) * H + h;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (has_col<DH>(u, td))
          dq[row * DH + 64 * u + 4 * td + e] = dq_acc[a][4 * u + e] * scale;
  }
}

// bf16: two warp-specialised kernels on wgmma, their operands by TMA.  A
// CTA is two consumer warpgroups and a producer warp, which issues the TMA
// loads (one thread; in dK/dV its lanes also stage lse and D).  Stationary
// 64-row operands are loaded once; the other operand pair streams in 64-row
// tiles through a ring of BWD_STAGES stages with full / empty mbarriers.
// Every tile lies in shared memory in the forward's 128-byte-swizzled
// layout (a box of 64 dh x 64 rows per 64-wide column block, rows past the
// array's S or T zero-filled), which a wgmma descriptor reads K-major (dh
// along a row) or MN-major (transpose bit).

constexpr int WG = 128;                      // threads of a warpgroup
// two consumers and a producer: 168 registers a thread (the note at the top)
constexpr int BWD_WG_THREADS = 2 * WG + 32;
constexpr int BWD_STAGES = 3;                // streamed tile pairs
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, from the 1024-byte-aligned base: FIXED stationary 64-row
// tiles, BWD_STAGES pairs of streamed tiles, with HANDOVER (dK/dV) each
// stage's P^T hand-over (one fp32 fragment a thread) and lse (times log2 e)
// and D of its 64 query rows, then the mbarriers: stationary, then full,
// empty and P^T ready for each stage
template <int DH, int FIXED, bool HANDOVER>
struct BwdWgLayout {
  static constexpr int TILE = 64 * DH * 2;
  static constexpr int STAGE_OFF = FIXED * TILE;
  static constexpr int PT_OFF = STAGE_OFF + BWD_STAGES * 2 * TILE;
  static constexpr int PT_BYTES = HANDOVER ? WG * 32 * 4 : 0;
  static constexpr int STAT_OFF = PT_OFF + BWD_STAGES * PT_BYTES;
  static constexpr int STAT_BYTES = HANDOVER ? 2 * 64 * 4 : 0;
  static constexpr int BAR_OFF = STAT_OFF + BWD_STAGES * STAT_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 3 * BWD_STAGES) * 8 + 1024;
};
template <int DH>
using DkdvLayout = BwdWgLayout<DH, 2, true>;  // K and V of 64 keys
template <int DH>
using DqLayout = BwdWgLayout<DH, 4, false>;   // Q and dO of 2 x 64 rows

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

#define WG_O8(d, i)                                                 \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),       \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define WG_O32(d) WG_O8(d, 0), WG_O8(d, 8), WG_O8(d, 16), WG_O8(d, 24)

// d = A B as wgmma_ss_n64 with accumulate 0: d's old values are not read,
// so they need not stay live
__device__ __forceinline__ void wgmma_ss_n64_set(float (&d)[32], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_O32(d)
      : "l"(a), "l"(b), "r"(0)
      : "memory");
}

// one 64-row tile of a {dh, heads, rows, B} tensor map into the swizzled
// layout at dst, completing on bar: one box per 64-wide column block
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row,
                                         int b) {
#pragma unroll
  for (int c = 0; c < DH / SW_COLS; ++c)
    tma_load(dst + c * 64 * SW_BYTES, map, bar, c * SW_COLS, head, row, b);
}

// d (64 x 64) = A B^T summed over dh: A and B 64-row tiles read K-major
template <int DH>
__device__ __forceinline__ void gemm_nt(float (&d)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk / 4) * 64 * SW_BYTES + (kk % 4) * 32;
    const uint64_t da = sw128_desc(a + off, 16, 8 * SW_BYTES);
    const uint64_t db = sw128_desc(b + off, 16, 8 * SW_BYTES);
    if (kk == 0)
      wgmma_ss_n64_set(d, da, db);
    else
      wgmma_ss_n64(d, da, db, 1);
  }
}

// d (64 x DH) += A B: A (64 x 64) as bf16 fragments from registers, B a
// 64-row tile whose rows are the 64 summed indices, read MN-major
template <int DH>
__device__ __forceinline__ void gemm_rs(float (&d)[DH / 2],
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tn<DH>(d, a[kk],
                    sw128_desc(b + kk * 16 * SW_BYTES, 64 * SW_BYTES,
                               8 * SW_BYTES));
}

// a 64 x 64 accumulator fragment rounded to bf16 as the A fragments of a
// product over its columns: for columns 16 kk .. 16 kk + 15, register e
// holds elements 8 kk + 2 e and 8 kk + 2 e + 1
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4][4],
                                          const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = bf16x2_bits(
          __floats2bfloat162_rn(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]));
}

// the training masks (no offsets or lengths): S queries against T keys;
// causal or a window only at S == T (the entry refuses them otherwise)
__device__ __forceinline__ bool admits(int qpos, int kpos, int S, int T,
                                       int causal, int window) {
  bool ok = qpos < S && kpos < T;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// the 64 query rows from q0 against the 64 keys from k0: 0 if the masks
// admit no pair, 1 if they admit every pair, 2 otherwise (masked per element)
__device__ __forceinline__ int block_kind(int q0, int k0, int S, int T,
                                          int causal, int window) {
  if (q0 >= S || k0 >= T || (causal && k0 > q0 + 63) ||
      (window > 0 && k0 + 63 <= q0 - window))
    return 0;
  if (q0 + 64 > S || k0 + 64 > T || (causal && k0 + 63 > q0) ||
      (window > 0 && k0 <= q0 + 63 - window))
    return 2;
  return 1;
}

// rows r0 and r0 + 8 of a (64 x pad64(DH)) accumulator fragment, times
// scale, into rows row0 + r of one head of a (B, n, heads, DH) bf16 array
// (n = S for dQ, T for dK and dV); rows at or past n and the pad columns
// are not written
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[pad64(DH) / 2],
                                           float scale, int b, int row0,
                                           int n, int heads, int head, int r0,
                                           int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* out =
        dst + (((size_t)b * n + row) * heads + head) * DH + 2 * tq;
#pragma unroll
    for (int jn = 0; jn < DH / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jn) =
          __floats2bfloat162_rn(acc[4 * jn + 2 * r] * scale,
                                acc[4 * jn + 2 * r + 1] * scale);
  }
}

// bf16: dK and dV of one 64-key tile of KV head kvh, lane b, summed over
// the G query heads of the group and the query tiles the masks admit.
// Stationary: the tile's K and V.  Streamed by the producer warp: Q and dO
// tiles of 64 query rows, with their lse and D.  The products run
// transposed, so that P and dS stay in registers, and split between the
// warpgroups, each holding one 64 x dh accumulator: warpgroup 0 computes
// S^T = K Q^T, P^T = exp(scale S^T - lse) on the fragment (lse per column)
// and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T,
// dS^T = P^T o (dP^T - D) with P^T handed over through shared memory (each
// thread's fragment to the same thread of warpgroup 1), and dK += dS^T Q.
// P^T and dS^T enter dV and dK rounded to bf16 as A fragments, dO and Q
// read MN-major.  Tiles are DP = pad64(DH) wide (the note at the top).
template <int DH>
__global__ void __launch_bounds__(BWD_WG_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int S, int T,
                            int H, int KV, int causal, int window,
                            float scale) {
  constexpr int DP = pad64(DH);
  using L = DkdvLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8;  // stage st: + 8 st
  const uint32_t bar_empty = bar_full + 8 * BWD_STAGES;
  const uint32_t bar_pt = bar_empty + 8 * BWD_STAGES;

  const int k0 = blockIdx.x * 64;  // tile 0, the most work, first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  // query rows that admit a key of [k0, k0 + 64): causal q >= k0; window
  // q < k + window for the tile's last key
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + 63 + window) : S;
  const int n_q = q_first < q_end ? (q_end - q_first + 63) / 64 : 0;
  const int n = G * n_q;  // tile j: head kvh G + j / n_q, tile j % n_q

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < BWD_STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * st, 2 * WG);
      mbar_init(bar_pt + 8 * st, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across the warp (a shuffle); warpgroup 2 is the
  // producer warp
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (w == 2) {
    const int lane = threadIdx.x - 2 * WG;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::TILE);
      tma_tile<DP>(base, &tm_k, bar_kv, kvh, k0, b);
      tma_tile<DP>(base + L::TILE, &tm_v, bar_kv, kvh, k0, b);
    }
    // lse (times log2 e) and D of rows lane and lane + 32 of tile t, loaded
    // a tile ahead (rows past S get 0: masked)
    float st_l[2], st_d[2];
    auto load_stats = [&](int t) {
      const int h = kvh * G + t / n_q;
      const int q0 = q_first + (t % n_q) * 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = q0 + lane + 32 * r < S;
        const size_t at = ((size_t)b * S + q0 + lane + 32 * r) * H + h;
        st_l[r] = in ? lse[at] * LOG2E : 0.f;
        st_d[r] = in ? delta[at] : 0.f;
      }
    };
    if (n > 0) load_stats(0);
    for (int t = 0; t < n; ++t) {  // tile t, once t - BWD_STAGES left
      const int st = t % BWD_STAGES;
      if (t >= BWD_STAGES)
        mbar_wait(bar_empty + 8 * st, (t / BWD_STAGES - 1) & 1);
      float* stat =
          reinterpret_cast<float*>(smem + L::STAT_OFF + st * L::STAT_BYTES);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stat[lane + 32 * r] = st_l[r];
        stat[64 + lane + 32 * r] = st_d[r];
      }
      const uint32_t bar = bar_full + 8 * st;
      if (lane == 0) {  // its arrival carries the tiles' bytes
        const uint32_t dst = base + L::STAGE_OFF + st * 2 * L::TILE;
        const int h = kvh * G + t / n_q;
        const int q0 = q_first + (t % n_q) * 64;
        mbar_expect_tx(bar, 2 * L::TILE);
        tma_tile<DP>(dst, &tm_q, bar, h, q0, b);
        tma_tile<DP>(dst + L::TILE, &tm_do, bar, h, q0, b);
      } else {
        mbar_arrive(bar);
      }
      if (t + 1 < n) load_stats(t + 1);
    }
    return;
  }

  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;
  // fragment: rows (keys) r0 and r0 + 8 of the tile; element i is row
  // r0 + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 tq + (i & 1)
  const int r0 = 16 * warp + lane / 4;
  const float c2 = scale * LOG2E;
  float acc[DP / 2];  // dV (warpgroup 0) or dK (warpgroup 1), unscaled
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n; ++j) {
    const int st = j % BWD_STAGES;
    const int q0 = q_first + (j % n_q) * 64;
    const uint32_t qb = base + L::STAGE_OFF + st * 2 * L::TILE;
    const uint32_t dob = qb + L::TILE;
    float* pt = reinterpret_cast<float*>(smem + L::PT_OFF + st * L::PT_BYTES);
    const float* stat =
        reinterpret_cast<const float*>(smem + L::STAT_OFF + st * L::STAT_BYTES);
    mbar_wait(bar_full + 8 * st, (j / BWD_STAGES) & 1);
    const int kind = block_kind(q0, k0, S, T, causal, window);
    if (w == 0) {
      if (kind != 0) {
        float s[32];
        uint32_t pa[4][4];
        wgmma_fence();
        gemm_nt<DH>(s, base, qb);  // S^T = K Q^T
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i / 4) + 2 * tq + (i & 1);
          float p = fast_exp2(fmaf(s[i], c2, -stat[c]));
          if (kind == 2 && !admits(q0 + c, k0 + r0 + 8 * ((i >> 1) & 1), S,
                                   T, causal, window))
            p = 0.f;
          s[i] = p;
        }
        // P^T to warpgroup 1: element i of thread tid at float4 i / 4 of
        // row tid (a warp's 32 float4 are contiguous)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<float4*>(pt + (k * WG + tid) * 4) =
              make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
        mbar_arrive(bar_pt + 8 * st);
        to_a_frag(pa, s);
        reg_fence(acc);
        wgmma_fence();
        gemm_rs<DP>(acc, pa, dob);  // dV += P^T dO
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
      } else {
        mbar_arrive(bar_pt + 8 * st);  // one phase a tile
      }
    } else if (kind != 0) {
      float dp[32];
      uint32_t dsa[4][4];
      wgmma_fence();
      gemm_nt<DH>(dp, base + L::TILE, dob);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp);
      mbar_wait(bar_pt + 8 * st, (j / BWD_STAGES) & 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pt + (k * WG + tid) * 4);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * k + e;
          const int c = 8 * (i / 4) + 2 * tq + (i & 1);
          dp[i] = p[e] * (dp[i] - stat[64 + c]);
        }
      }
      to_a_frag(dsa, dp);
      reg_fence(acc);
      wgmma_fence();
      gemm_rs<DP>(acc, dsa, qb);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    }
    mbar_arrive(bar_empty + 8 * st);  // this warpgroup is done with the stage
  }
  if (w == 0)
    store_rows<DH>(dv, acc, 1.f, b, k0, T, KV, kvh, r0, tq);
  else
    store_rows<DH>(dk, acc, scale, b, k0, T, KV, kvh, r0, tq);
}

// bf16: dQ of 128 query rows of head h, lane b, over the key tiles the masks
// admit.  Stationary: warpgroup w's 64 rows of Q and dO, with their lse
// and D in registers.  Streamed by the producer warp: K and V tiles of 64
// keys.  S = Q K^T and
// dP = dO V^T; P and dS = P o (dP - D) on the fragment; dQ += dS K with dS
// rounded to bf16 as A fragments and K read MN-major.  Tiles are DP =
// pad64(DH) wide.
template <int DH>
__global__ void __launch_bounds__(BWD_WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int T,
                          int H, int KV, int causal, int window,
                          float scale) {
  constexpr int DP = pad64(DH);
  using L = DqLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;  // stage st: + 8 st
  const uint32_t bar_empty = bar_full + 8 * BWD_STAGES;

  // causal: the last query tile has the most keys, so it runs first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  // keys admissible to a row of [q0, q0 + 128): causal k <= q; window
  // k > q - window for the tile's first row
  const int k_end = causal ? min(T, q0 + 128) : T;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_lo / 64) * 64;
  const int n = k_first < k_end ? (k_end - k_first + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < BWD_STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across the warp (a shuffle); warpgroup 2 is the
  // producer warp
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (w == 2) {  // one thread issues every load
    if (threadIdx.x != 2 * WG) return;
    mbar_expect_tx(bar_q, 4 * L::TILE);
    for (int u = 0; u < 2; ++u) {
      tma_tile<DP>(base + u * L::TILE, &tm_q, bar_q, h, q0 + 64 * u, b);
      tma_tile<DP>(base + (2 + u) * L::TILE, &tm_do, bar_q, h, q0 + 64 * u,
                   b);
    }
    for (int t = 0; t < n; ++t) {  // key tile t, once t - BWD_STAGES left
      const int st = t % BWD_STAGES;
      if (t >= BWD_STAGES)
        mbar_wait(bar_empty + 8 * st, (t / BWD_STAGES - 1) & 1);
      const uint32_t bar = bar_full + 8 * st;
      const uint32_t dst = base + L::STAGE_OFF + st * 2 * L::TILE;
      mbar_expect_tx(bar, 2 * L::TILE);
      tma_tile<DP>(dst, &tm_k, bar, kvh, k_first + 64 * t, b);
      tma_tile<DP>(dst + L::TILE, &tm_v, bar, kvh, k_first + 64 * t, b);
    }
    return;
  }

  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;
  // fragment: query rows r0 and r0 + 8 of the warpgroup's 64; element i is
  // row r0 + 8 ((i >> 1) & 1), key 8 (i / 4) + 2 tq + (i & 1)
  const int r0 = 16 * warp + lane / 4;
  const int qw = q0 + 64 * w;
  const uint32_t qa = base + w * L::TILE, doa = base + (2 + w) * L::TILE;
  const float c2 = scale * LOG2E;
  float lse2[2], dd[2];  // rows past S get 0 (masked)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qw + r0 + 8 * r < S;
    const size_t at = ((size_t)b * S + qw + r0 + 8 * r) * H + h;
    lse2[r] = in ? lse[at] * LOG2E : 0.f;
    dd[r] = in ? delta[at] : 0.f;
  }
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n; ++j) {
    const int st = j % BWD_STAGES;
    const int kt = k_first + 64 * j;
    mbar_wait(bar_full + 8 * st, (j / BWD_STAGES) & 1);
    const int kind = block_kind(qw, kt, S, T, causal, window);
    if (kind != 0) {
      const uint32_t kb = base + L::STAGE_OFF + st * 2 * L::TILE;
      const uint32_t vb = kb + L::TILE;
      float s[32], dp[32];
      uint32_t dsa[4][4];
      wgmma_fence();
      gemm_nt<DH>(s, qa, kb);  // S = Q K^T
      wgmma_commit();
      gemm_nt<DH>(dp, doa, vb);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = fast_exp2(fmaf(s[i], c2, -lse2[r]));
        if (kind == 2 && !admits(qw + r0 + 8 * r,
                                 kt + 8 * (i / 4) + 2 * tq + (i & 1), S, T,
                                 causal, window))
          p = 0.f;
        s[i] = p;
      }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dd[(i >> 1) & 1]);
      to_a_frag(dsa, dp);
      reg_fence(dq_acc);
      wgmma_fence();
      gemm_rs<DP>(dq_acc, dsa, kb);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq_acc);
    }
    mbar_arrive(bar_empty + 8 * st);  // this warpgroup is done with the stage
  }
  store_rows<DH>(dq, dq_acc, scale, b, qw, S, H, h, r0, tq);
}

// bf16: the tensor maps of q and dout (H heads) and k and v (KV heads), then
// the dK/dV and dQ kernels
template <int DH>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk,
                             void* dv, int B, int S, int T, int H, int KV,
                             int causal, int window, float scale,
                             cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  cudaError_t err = kv_map(&tm_q, q, B, S, H, DH);
  if (err == cudaSuccess) err = kv_map(&tm_do, dout, B, S, H, DH);
  if (err == cudaSuccess) err = kv_map(&tm_k, k, B, T, KV, DH);
  if (err == cudaSuccess) err = kv_map(&tm_v, v, B, T, KV, DH);
  if (err != cudaSuccess) return err;
  const int smem_kv = DkdvLayout<pad64(DH)>::BYTES;
  const int smem_q = DqLayout<pad64(DH)>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<DH>
      <<<dim3((T + 63) / 64, KV, B), BWD_WG_THREADS, smem_kv, stream>>>(
          tm_q, tm_do, tm_k, tm_v, lse, delta,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          S, T, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<DH>
      <<<dim3((S + 127) / 128, H, B), BWD_WG_THREADS, smem_q, stream>>>(
          tm_q, tm_do, tm_k, tm_v, lse, delta,
          static_cast<__nv_bfloat16*>(dq), S, T, H, KV, causal, window,
          scale);
  return cudaGetLastError();
}

// CTAs per SM of the bf16 product kernels at their block size and shared
// memory: out[0] dK/dV, out[1] dQ
template <int DH>
cudaError_t bwd_occupancy(int* out) {
  const int smem_kv = DkdvLayout<pad64(DH)>::BYTES;
  const int smem_q = DqLayout<pad64(DH)>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, flash_bwd_dkdv_wgmma_kernel<DH>, BWD_WG_THREADS, smem_kv);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, flash_bwd_dq_wgmma_kernel<DH>, BWD_WG_THREADS, smem_q);
  return err;
}

// D, then dK/dV and dQ: the FMA kernels for fp32, the wgmma ones for bf16
template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int S, int T_len, int H, int KV, int causal,
                       int window, float scale, cudaStream_t stream) {
  const T* tdo = static_cast<const T*>(dout);
  const int rows = B * S * H;
  const int per_cta = BWD_THREADS / 32;
  flash_bwd_delta_kernel<T, DH><<<(rows + per_cta - 1) / per_cta, BWD_THREADS,
                                  0, stream>>>(static_cast<const T*>(o), tdo,
                                               delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2) {
    return launch_bwd_wgmma<DH>(q, k, v, dout, lse, delta, dq, dk, dv, B, S,
                                T_len, H, KV, causal, window, scale, stream);
  } else {
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const int smem = (int)BwdLayout<DH>::BYTES;
    const dim3 kv_grid((T_len + BWD_TILE - 1) / BWD_TILE, KV, B);
    const dim3 q_grid((S + BWD_TILE - 1) / BWD_TILE, H, B);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<DH><<<kv_grid, BWD_THREADS, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        S, T_len, H, KV, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<DH><<<q_grid, BWD_THREADS, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, T_len, H, KV,
        causal, window, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: the (B,S,H) fp32 row log-sum-exp
// of the scaled scores (+inf on a row with no admissible key), written only
// when not null (the training path's forward; serving passes null).
// q_offset / kv_len: int32 (B,) device pointers or null.  window <= 0 means
// no window.  bf16 k and v must be contiguous with 16-byte-aligned bases
// (the tensor maps' rule).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* q_offset, const void* kv_len,
                                   int B, int S, int T_len, int H, int KV,
                                   int dh, int dtype, int causal, int window,
                                   float scale, void* stream) {
  return dispatch<false>(q, k, v, o, static_cast<float*>(lse), nullptr,
                         q_offset, kv_len, B, S, T_len, H, KV, dh, dtype,
                         causal, window, scale, stream);
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

// The gradients (dq, dk, dv) of flash_attention_fwd's output against dout,
// for the training path's masks only, no q_offset or kv_len: at S == T
// causal or not, window <= 0 (none) or a positive span; at S != T
// (cross-attention) neither causal nor a window.  q, o, dout, dq are
// (B,S,H,dh), k, v, dk, dv (B,T,KV,dh), all of dtype (0 = float32,
// 1 = bfloat16), contiguous with 16-byte-aligned bases; lse is the
// forward's (B,S,H) fp32 row log-sum-exp; delta (B,S,H) fp32 is scratch
// for D = rowsum(dout o o).  Returns the CUDA error of the launches (0 on
// success), cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int S, int T_len, int H, int KV,
                                   int dh, int dtype, int causal, int window,
                                   float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || window < 0 ||
      (S != T_len && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  if (B * S == 0 || T_len == 0) return 0;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto dh_c) -> int {
    constexpr int DH = decltype(dh_c)::value;
    if (dtype == 1)
      return launch_bwd<__nv_bfloat16, DH>(q, k, v, o, dout, l, dq, dk, dv, d,
                                           B, S, T_len, H, KV, causal, window,
                                           scale, st);
    return launch_bwd<float, DH>(q, k, v, o, dout, l, dq, dk, dv, d, B, S,
                                 T_len, H, KV, causal, window, scale, st);
  };
  return with_head_dim(dh, dtype, run);
}

// CTAs per SM of the bf16 backward's dK/dV and dQ kernels: out[0], out[1]
// at dh 64, out[2], out[3] at dh 112, out[4], out[5] at dh 128.  Returns
// the CUDA error (0 on success).
extern "C" int flash_attention_bwd_occupancy(int* out) {
  cudaError_t err = bwd_occupancy<64>(out);
  if (err == cudaSuccess) err = bwd_occupancy<112>(out + 2);
  if (err == cudaSuccess) err = bwd_occupancy<128>(out + 4);
  return (int)err;
}
