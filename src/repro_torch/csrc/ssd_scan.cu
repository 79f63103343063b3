// Mamba2 SSD chunked scan for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), which has no backward: the JAX package differentiates its
// plain version, models/ssm.py::ssd_chunked.  Same function:
//   x (B,S,H,P), dt (B,S,H) fp32 > 0, A (H,) fp32 < 0, Bm/Cm (B,S,H,N)
//   -> y (B,S,H,P) in x's dtype, with a zero initial state.
// Bm/Cm may hold G groups, G dividing H: head h reads group h / (H / G)
// (models/ssm.py passes one group for every head, as (B,S,1,N)).
// Per chunk of Q steps, with g the inclusive cumsum of dt*a inside the chunk,
// L_ts = exp(g_t - g_s) for t >= s (never exp of a positive argument) and
// S the fp32 (P,N) state at the chunk's start:
//   y_t  = sum_s (C_t.B_s) L_ts dt_s x_s + exp(g_t) S C_t
//   S   <- exp(g_Q) S + sum_s exp(g_Q - g_s) dt_s x_s B_s^T
// The fp32 backward (ssd_bwd_kernel) recomputes the chunk-start states in a
// forward walk into a transient buffer, then walks the chunks in reverse
// carrying dS, the gradient of the state at the chunk's end:
//   dS_prev = exp(g_Q) dS + sum_t exp(g_t) dy_t C_t^T
//   dx_s = sum_t (C_t.B_s) L_ts dt_s dy_t + exp(g_Q - g_s) dt_s dS B_s
//   dC_t = sum_s W_ts B_s + exp(g_t) S^T dy_t,   W_ts = L_ts dt_s (dy_t.x_s)
//   dB_s = sum_t W_ts C_t + exp(g_Q - g_s) dt_s dS^T x_s
// and dg (the gradient of g) from L, exp(g_t) and the state decay; then
// d(dt*a) is the reverse cumsum of dg, ddt = a d(dt*a) + the direct terms
// and da = sum dt d(dt*a).  Terms of dg that cancel exactly in d(dt*a) are
// left out rather than added and subtracted in fp32, where their rounding
// would remain: the diagonal of L (L_tt = 1 for every g), and the decay of
// the last step to the chunk's end (exp(g_Q - g_s) gives +w_s u_s at Q and
// -w_s u_s at s, so d(dt*a)_t gets sum_{s<t} w_s u_s, a forward prefix).  Each head writes its dB and dC terms once
// into (B,S,H,N) fp32 buffers, which the wrapper sums over the heads of a
// group in a fixed order and rounds once to x's dtype: no atomics, so the
// same bits on every run (summing into one buffer with atomics, as the
// first versions did, changed the last bits from run to run, and training
// steps with them).  da is written per (batch, head) as fp32 partials that
// the wrapper sums over the batch in a fixed order.
//
// The bf16 backward computes the same terms chunk-parallel, in three
// kernels (ssd_bwd_*, below): (a) per (batch, head, chunk) the chunk's
// decays and its two state terms U_c = sum_s w_s x_s B_s^T and
// V_c = sum_t exp(g_t) dy_t C_t^T into fp32 scratch; (b) per state entry,
// a forward pass that turns U in place into the chunk-start states
// (S_{c+1} = exp(g_Q,c) S_c + U_c) and a reverse pass that turns V into dS,
// the end-state gradients (dS_c = exp(g_Q,c+1) dS_{c+1} + V_{c+1}, 0 for
// the last chunk); (c) per (batch, head, chunk) the gradients above from
// S_c and dS_c, with one da partial per chunk.
//
// The bf16 forward shares (a) and (b), in three kernels of its own
// (ssd_fwd_*, below): (a') per (batch, head, chunk) the decays and U_c
// alone; (b') the forward pass of (b) alone, U -> S in place; (c') per
// (batch, head, chunk) y_t = sum_s M_ts x_s + exp(g_t) S_c C_t for the
// chunk's rows, written once (no atomics).  fp32 inputs run the exact FMA
// kernel ssd_fwd_kernel, one CTA per (batch, head) walking its chunks.
//
// What bounds it on the H100: at the training shape (B 8, S 2048, H 32,
// P 64, N 128, Q 64) the forward moves about 144 MB (bf16 x, y, B, C, fp32
// dt): 43 us by bytes.  Its 30 GFLOP would take 30 us at the bf16
// tensor-core peak but 0.45 ms at the fp32 FMA peak.  The fp32 forward (and
// the fp32 backward) keep every operand of a chunk in shared memory (fp32,
// rows padded to an odd stride so that row and column reads are free of
// bank conflicts) and run the chunk's products as register-tiled FMA loops:
// 256 threads in a 16 x 16 layout, each owning up to 4 x 8 outputs, loading
// 12 operands for 32 FMAs; the grid is B*H CTAs.  The bf16 forward runs its
// products on tensor cores, B*H*nc CTAs in (a') and (c'); its fp32 states,
// written by (a'), read and written by (b'), read by (c'), move about
// 1.1 GB beside the 0.14 GB of the function's own bytes, so the state
// traffic bounds it (about 0.37 ms at 3.35 TB/s).
// The bf16 backward's 77 GFLOP would take 78 us on bf16 tensor cores; its
// fp32 states, written by (a), passed over twice by (b) and read by (c),
// move about 2 GB, so bytes bound it (about 0.6 ms).  Its design answers
// the FMA version's limits: the grid is B*H*nc CTAs, not B*H; the products
// run on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with operands from
// shared memory through ldmatrix; an fp32 operand (M, W, the decay-scaled
// rows, S, dS) is split into bf16 hi + lo and multiplied twice into one
// fp32 accumulator, so products keep about 16 bits of it; operands sit in
// shared memory as bf16 (rows padded by 16 bytes, free of ldmatrix bank
// conflicts), S and dS in halves of N, so that two CTAs fit on an SM and
// hide each other's loads; bf16 inputs are loaded with 16-byte cp.async;
// the cumsums run as warp scans; dB and dC leave as 4-wide fp32 stores
// into the per-head buffers (0.54 GB written at the training shape, which
// the wrapper's sum reads again).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 layout of output micro-tiles
constexpr int MAX_Q = 64;     // rows of a micro-tiled product: <= 4 * 16
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;    // columns: <= 8 * 16

struct Dims {
  int B, S, H, G, P, N, Q, nc;
};

// element strides of the inputs, in the order (batch, seq, head, last)
struct Strides {
  long long x[4], dt[3], bm[4], cm[4], dy[4];
};

// acc(i, j) += sum_k a(i, k) * ks[k] * b(k, j) over the M x Nc outputs that
// this thread owns: rows ty + 16 ii, columns tx + 16 jj.  a(i, k) is
// a[i * a_i + k * a_k], b(k, j) is b[k * b_k + j * b_j]; ks may be null.
template <int MI, int NJ>
__device__ __forceinline__ void mm_acc(float (&acc)[MI][NJ], const float* a,
                                       int a_i, int a_k, const float* b,
                                       int b_k, int b_j, int M, int Nc, int K,
                                       const float* ks) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float sc = ks ? ks[k] : 1.f;
    float av[MI], bv[NJ];
#pragma unroll
    for (int ii = 0; ii < MI; ++ii) {
      const int i = ty + 16 * ii;
      av[ii] = i < M ? a[i * a_i + k * a_k] * sc : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = tx + 16 * jj;
      bv[jj] = j < Nc ? b[k * b_k + j * b_j] : 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < MI; ++ii)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ]) {
#pragma unroll
  for (int ii = 0; ii < MI; ++ii)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[ii][jj] = 0.f;
}

// sum over the 16 threads that own one row (one aligned half-warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [s0, s0 + Q) of a (B,S,H,W) tensor at (b, h) into dst (Q x W, row
// stride W + 1) as fp32; rows past S are zeros
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const long long* st, int b, int h,
                                          int s0, int Q, int W, int S) {
  const float* base = src + b * st[0] + h * st[2];
  for (int i = threadIdx.x; i < Q * W; i += THREADS) {
    const int t = i / W, w = i % W;
    const int s = s0 + t;
    dst[t * (W + 1) + w] = s < S ? base[s * st[1] + w * st[3]] : 0.f;
  }
}

// dt of the chunk, its inclusive cumsum g of dt * a, exp(g), and the decay
// to the chunk's end exp(g_Q - g); returns nothing, fills the four vectors
__device__ __forceinline__ void chunk_decays(float* sdt, float* sg, float* seg,
                                             float* sdec, const float* dt,
                                             const long long* st, int b, int h,
                                             int s0, int Q, int S, float a) {
  for (int t = threadIdx.x; t < Q; t += THREADS) {
    const int s = s0 + t;
    sdt[t] = s < S ? dt[b * st[0] + s * st[1] + h * st[2]] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int t = 0; t < Q; ++t) {
      c += sdt[t] * a;
      sg[t] = c;
    }
  }
  __syncthreads();
  const float gq = sg[Q - 1];
  for (int t = threadIdx.x; t < Q; t += THREADS) {
    seg[t] = expf(sg[t]);
    sdec[t] = expf(gq - sg[t]);
  }
}

// shared-memory layout, in floats (rows padded to an odd stride)
struct Smem {
  int qp, qn, pn, qq;
  __device__ __host__ Smem(const Dims& d)
      : qp(d.Q * (d.P + 1)), qn(d.Q * (d.N + 1)), pn(d.P * (d.N + 1)),
        qq(d.Q * (d.Q + 1)) {}
};

size_t fwd_smem_floats(const Dims& d) {
  const Smem m(d);
  return m.qp + 2 * m.qn + m.pn + m.qq + 5 * d.Q;
}

size_t bwd_smem_floats(const Dims& d) {
  const Smem m(d);
  return 2 * m.qp + 2 * m.qn + 2 * m.pn + 2 * m.qq + 16 * d.Q + 12 * d.Q +
         THREADS / 32;
}

// ---------------------------------------------------------------------------
// fp32 forward: one CTA per (batch, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y, Dims d,
               Strides st) {
  extern __shared__ float smem[];
  const Smem m(d);
  const int Q = d.Q, P = d.P, N = d.N;
  float* sx = smem;           // Q x (P+1)
  float* sB = sx + m.qp;      // Q x (N+1)
  float* sC = sB + m.qn;      // Q x (N+1)
  float* sS = sC + m.qn;      // P x (N+1): the state
  float* sM = sS + m.pn;      // Q x (Q+1)
  float* sdt = sM + m.qq;
  float* sg = sdt + Q;
  float* seg = sg + Q;
  float* sdec = seg + Q;
  float* sw = sdec + Q;       // exp(g_Q - g_s) dt_s

  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int grp = h / (d.H / d.G);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float a = A[h];
  for (int i = threadIdx.x; i < m.pn; i += THREADS) sS[i] = 0.f;

  for (int c = 0; c < d.nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk is no longer read
    load_rows(sx, x, st.x, b, h, s0, Q, P, d.S);
    load_rows(sB, bm, st.bm, b, grp, s0, Q, N, d.S);
    load_rows(sC, cm, st.cm, b, grp, s0, Q, N, d.S);
    chunk_decays(sdt, sg, seg, sdec, dt, st.dt, b, h, s0, Q, d.S, a);
    for (int t = threadIdx.x; t < Q; t += THREADS) sw[t] = sdec[t] * sdt[t];
    __syncthreads();

    {  // M_ts = (C_t . B_s) L_ts dt_s
      float acc[4][4];
      zero(acc);
      mm_acc(acc, sC, N + 1, 1, sB, 1, N + 1, Q, Q, N, nullptr);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = ty + 16 * ii, s = tx + 16 * jj;
          if (t < Q && s < Q)
            sM[t * (Q + 1) + s] =
                t >= s ? acc[ii][jj] * expf(sg[t] - sg[s]) * sdt[s] : 0.f;
        }
    }
    __syncthreads();

    {  // y_t = sum_s M_ts x_s + exp(g_t) S C_t
      float yd[4][4], yo[4][4];
      zero(yd);
      zero(yo);
      mm_acc(yd, sM, Q + 1, 1, sx, P + 1, 1, Q, P, Q, nullptr);
      mm_acc(yo, sC, N + 1, 1, sS, 1, N + 1, Q, P, N, nullptr);
      float* yb = y + ((size_t)b * d.S * d.H + h) * P;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = ty + 16 * ii, p = tx + 16 * jj;
          if (t < Q && p < P && s0 + t < d.S)
            yb[(size_t)(s0 + t) * d.H * P + p] =
                yd[ii][jj] + seg[t] * yo[ii][jj];
        }
    }
    __syncthreads();  // S is no longer read

    {  // S <- exp(g_Q) S + sum_s w_s x_s B_s^T
      float acc[4][8];
      zero(acc);
      mm_acc(acc, sx, 1, P + 1, sB, N + 1, 1, P, N, Q, sw);
      const float eq = seg[Q - 1];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int p = ty + 16 * ii, n = tx + 16 * jj;
          if (p < P && n < N) {
            float* sp = sS + p * (N + 1) + n;
            *sp = eq * *sp + acc[ii][jj];
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// backward: one CTA per (batch, head); states is a B*H*nc*P*N fp32 scratch;
// dB and dC are (B,S,H,N) fp32, each head's terms written once
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dy,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ da_part, float* __restrict__ dB,
               float* __restrict__ dC, float* __restrict__ states, Dims d,
               Strides st) {
  extern __shared__ float smem[];
  const Smem m(d);
  const int Q = d.Q, P = d.P, N = d.N;
  float* sx = smem;             // Q x (P+1)
  float* sdy = sx + m.qp;       // Q x (P+1)
  float* sB = sdy + m.qp;       // Q x (N+1)
  float* sC = sB + m.qn;        // Q x (N+1)
  float* sS = sC + m.qn;        // P x (N+1): state at the chunk's start
  float* sdS = sS + m.pn;       // P x (N+1): gradient of the end state
  float* sM = sdS + m.pn;       // Q x (Q+1): (C_t.B_s) L_ts dt_s
  float* sW = sM + m.qq;        // Q x (Q+1): L_ts dt_s (dy_t.x_s)
  float* scol = sW + m.qq;      // 16 x Q partial column sums
  float* sdt = scol + 16 * Q;
  float* sg = sdt + Q;
  float* seg = sg + Q;
  float* sdec = seg + Q;
  float* sw = sdec + Q;
  float* srowz = sw + Q;        // sum_{s<t} Z_ts dt_s, Z_ts = G_ts L_ts D_ts
  float* scolz = srowz + Q;     // sum_{t>s} Z_ts
  float* su = scolz + Q;        // x_s . (dS B_s)
  float* sv = su + Q;           // exp(g_t) dy_t . (S C_t)
  float* sdg = sv + Q;
  float* sdda = sdg + Q;
  float* sdiag = sdda + Q;      // Z_tt
  float* sred = sdiag + Q;      // THREADS / 32 warp partials

  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int grp = h / (d.H / d.G);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float a = A[h];
  float* st_bh = states + (size_t)blockIdx.x * d.nc * P * N;

  // 1. forward walk: the state at each chunk's start into `states`
  for (int i = threadIdx.x; i < m.pn; i += THREADS) sS[i] = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();
    load_rows(sx, x, st.x, b, h, s0, Q, P, d.S);
    load_rows(sB, bm, st.bm, b, grp, s0, Q, N, d.S);
    chunk_decays(sdt, sg, seg, sdec, dt, st.dt, b, h, s0, Q, d.S, a);
    for (int t = threadIdx.x; t < Q; t += THREADS) sw[t] = sdec[t] * sdt[t];
    __syncthreads();
    float acc[4][8];
    zero(acc);
    mm_acc(acc, sx, 1, P + 1, sB, N + 1, 1, P, N, Q, sw);
    const float eq = seg[Q - 1];
    float* out = st_bh + (size_t)c * P * N;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int p = ty + 16 * ii, n = tx + 16 * jj;
        if (p < P && n < N) {
          float* sp = sS + p * (N + 1) + n;
          out[p * N + n] = *sp;
          *sp = eq * *sp + acc[ii][jj];
        }
      }
  }

  // 2. reverse walk
  for (int i = threadIdx.x; i < m.pn; i += THREADS) sdS[i] = 0.f;
  float da = 0.f;  // thread 0's running sum of dt * d(dt a)
  for (int c = d.nc - 1; c >= 0; --c) {
    const int s0 = c * Q;
    __syncthreads();
    load_rows(sx, x, st.x, b, h, s0, Q, P, d.S);
    load_rows(sdy, dy, st.dy, b, h, s0, Q, P, d.S);
    load_rows(sB, bm, st.bm, b, grp, s0, Q, N, d.S);
    load_rows(sC, cm, st.cm, b, grp, s0, Q, N, d.S);
    {
      const float* in = st_bh + (size_t)c * P * N;
      for (int i = threadIdx.x; i < P * N; i += THREADS)
        sS[(i / N) * (N + 1) + i % N] = in[i];
    }
    chunk_decays(sdt, sg, seg, sdec, dt, st.dt, b, h, s0, Q, d.S, a);
    for (int t = threadIdx.x; t < Q; t += THREADS) sw[t] = sdec[t] * sdt[t];
    __syncthreads();

    {  // G = C B^T and D = dy x^T -> M, W, and the sums of Z
      float G[4][4], D[4][4];
      zero(G);
      zero(D);
      mm_acc(G, sC, N + 1, 1, sB, 1, N + 1, Q, Q, N, nullptr);
      mm_acc(D, sdy, P + 1, 1, sx, 1, P + 1, Q, Q, P, nullptr);
      float colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int t = ty + 16 * ii;
        float rowp = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int s = tx + 16 * jj;
          float mv = 0.f, wv = 0.f, zv = 0.f;
          if (t < Q && s < Q && t >= s) {
            const float l = expf(sg[t] - sg[s]);
            mv = G[ii][jj] * l * sdt[s];
            wv = l * sdt[s] * D[ii][jj];
            zv = G[ii][jj] * l * D[ii][jj];
          }
          if (t < Q && s < Q) {
            sM[t * (Q + 1) + s] = mv;
            sW[t * (Q + 1) + s] = wv;
            if (t == s) sdiag[t] = zv;
          }
          if (t > s && s < Q) {  // off the diagonal (see the top)
            rowp += zv * sdt[s];
            colp[jj] += zv;
          }
        }
        rowp = row_sum(rowp);
        if (tx == 0 && t < Q) srowz[t] = rowp;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int s = tx + 16 * jj;
        if (s < Q) scol[ty * Q + s] = colp[jj];
      }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < Q; s += THREADS) {
      float z = 0.f;
      for (int r = 0; r < 16; ++r) z += scol[r * Q + s];
      scolz[s] = z;
    }

    const size_t row = (size_t)d.H;  // rows of (B,S,H,*) outputs
    // this head's rows of the (B,S,H,N) dB and dC terms
    const size_t grow = (size_t)d.H * N;
    const size_t gbase = ((size_t)b * d.S * d.H + h) * N;
    {  // dx_s = sum_t M_ts dy_t + w_s dS B_s;  u_s = x_s . (dS B_s)
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      mm_acc(a1, sM, 1, Q + 1, sdy, P + 1, 1, Q, P, Q, nullptr);
      mm_acc(a2, sB, N + 1, 1, sdS, 1, N + 1, Q, P, N, nullptr);
      float* out = dx + ((size_t)b * d.S * d.H + h) * P;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = ty + 16 * ii;
        float up = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int p = tx + 16 * jj;
          if (s < Q && p < P) {
            up += sx[s * (P + 1) + p] * a2[ii][jj];
            if (s0 + s < d.S)
              out[(size_t)(s0 + s) * row * P + p] =
                  a1[ii][jj] + sw[s] * a2[ii][jj];
          }
        }
        up = row_sum(up);
        if (tx == 0 && s < Q) su[s] = up;
      }
    }
    {  // dB_s = sum_t W_ts C_t + w_s dS^T x_s
      float a1[4][8], a2[4][8];
      zero(a1);
      zero(a2);
      mm_acc(a1, sW, 1, Q + 1, sC, N + 1, 1, Q, N, Q, nullptr);
      mm_acc(a2, sx, P + 1, 1, sdS, N + 1, 1, Q, N, P, nullptr);
      float* out = dB + gbase;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int s = ty + 16 * ii, n = tx + 16 * jj;
          if (s < Q && n < N && s0 + s < d.S)
            out[(size_t)(s0 + s) * grow + n] =
                a1[ii][jj] + sw[s] * a2[ii][jj];
        }
    }
    {  // dC_t = sum_s W_ts B_s + exp(g_t) S^T dy_t;  v_t = C_t . (that)
      float a1[4][8], a2[4][8];
      zero(a1);
      zero(a2);
      mm_acc(a1, sW, Q + 1, 1, sB, N + 1, 1, Q, N, Q, nullptr);
      mm_acc(a2, sdy, P + 1, 1, sS, N + 1, 1, Q, N, P, nullptr);
      float* out = dC + gbase;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int t = ty + 16 * ii;
        float vp = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = tx + 16 * jj;
          if (t < Q && n < N) {
            const float off = seg[t] * a2[ii][jj];
            vp += sC[t * (N + 1) + n] * off;
            if (s0 + t < d.S)
              out[(size_t)(s0 + t) * grow + n] = a1[ii][jj] + off;
          }
        }
        vp = row_sum(vp);
        if (tx == 0 && t < Q) sv[t] = vp;
      }
    }
    {  // dS <- exp(g_Q) dS + sum_t exp(g_t) dy_t C_t^T;  sum dS * S
      float acc[4][8];
      zero(acc);
      mm_acc(acc, sdy, 1, P + 1, sC, N + 1, 1, P, N, Q, seg);
      const float eq = seg[Q - 1];
      float part = 0.f;
      __syncthreads();  // every read of dS above is done
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int p = ty + 16 * ii, n = tx + 16 * jj;
          if (p < P && n < N) {
            float* sp = sdS + p * (N + 1) + n;
            part += *sp * sS[p * (N + 1) + n];
            *sp = eq * *sp + acc[ii][jj];
          }
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = part;
    }
    __syncthreads();

    // dg without the terms that cancel; d(dt a) as its reverse cumsum plus
    // the forward prefix of w u (see the top); then ddt and da
    for (int t = threadIdx.x; t < Q; t += THREADS)
      sdg[t] = srowz[t] - scolz[t] * sdt[t] + sv[t];
    __syncthreads();
    if (threadIdx.x == 0) {
      float dss = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) dss += sred[w];
      sdg[Q - 1] += seg[Q - 1] * dss;
      float p = 0.f;
      for (int t = 0; t < Q; ++t) {
        sdda[t] = p;
        p += sw[t] * su[t];
      }
      float r = 0.f;
      for (int t = Q - 1; t >= 0; --t) {
        r += sdg[t];
        sdda[t] += r;
        da += sdt[t] * sdda[t];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < Q; t += THREADS)
      if (s0 + t < d.S)
        ddt[((size_t)b * d.S + s0 + t) * d.H + h] =
            a * sdda[t] + scolz[t] + sdiag[t] + sdec[t] * su[t];
  }
  if (threadIdx.x == 0) da_part[blockIdx.x] = da;
}

// ---------------------------------------------------------------------------
// bf16, chunk-parallel on tensor cores.  Backward: (a) ssd_bwd_chunk_state_
// kernel, (b) ssd_bwd_state_pass_kernel, (c) ssd_bwd_chunk_grad_kernel.
// Forward: (a') ssd_fwd_chunk_state_kernel and (b') ssd_fwd_state_pass_
// kernel, the U halves of (a) and (b), then (c') ssd_fwd_chunk_scan_kernel.
// A chunk is a 64-row tile: rows past Q or S are zeros with dt = 0, so g
// stays at the chunk's last value there and they add nothing; P and N are
// zero-padded to 64 and 128.  states and dstates are B*H*nc*P*N fp32
// scratch, chunk_decay B*H*nc fp32.
// ---------------------------------------------------------------------------

constexpr int TQ = 64;        // rows of a chunk tile
constexpr int LD64 = 72;      // bf16 row stride of a 64-wide tile (+16 B)
constexpr int LD128 = 136;    // bf16 row stride of a 128-wide tile (+16 B)
constexpr int TILE64 = TQ * LD64;
constexpr int TILE128 = TQ * LD128;

// bits of MmaArgs::vec: the bf16 input's rows may be read 16 bytes at once
enum { VEC_X = 1, VEC_DY = 2, VEC_B = 4, VEC_C = 8 };

struct MmaArgs {
  const __nv_bfloat16 *x, *bm, *cm, *dy;
  const float *dt, *A;
  __nv_bfloat16 *y, *dx;
  float *ddt, *da_part, *dB, *dC, *states, *dstates, *chunk_decay;
  Dims d;
  Strides st;
  int vec;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i; .trans delivers each matrix transposed
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const __nv_bfloat16* p) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 x 32 output tile at rows m0, columns n0: acc[j] is the
// m16n8 accumulator of columns n0 + 8j, and acc += A(m0.., k) B(k, n0..)
// over k in [k0, k1) (multiples of 16).  A(m, k) is a[m * lda + k], or
// a[k * lda + m] if AT; B(k, n) is b[n * ldb + k], or b[k * ldb + n] if BT.
// Accumulator element i of acc[j] is row m0 + g + 8 (i / 2), column
// n0 + 8 j + 2 c + i % 2, with g = lane / 4 and c = lane % 4.
template <bool AT, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb,
                                         int m0, int n0, int k0, int k1) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  for (int k = k0; k < k1; k += 16) {
    unsigned af[4];
    if (AT)
      ldsm_x4<true>(af, a + (k + (i >> 1) * 8 + r) * lda + m0 + (i & 1) * 8);
    else
      ldsm_x4<false>(af, a + (m0 + (i & 1) * 8 + r) * lda + k + (i >> 1) * 8);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int nb = n0 + 16 * jj;
      unsigned bf[4];
      if (BT)
        ldsm_x4<true>(bf, b + (k + (i & 1) * 8 + r) * ldb + nb + (i >> 1) * 8);
      else
        ldsm_x4<false>(bf, b + (nb + (i >> 1) * 8 + r) * ldb + k + (i & 1) * 8);
      mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ int up16(int v) { return (v + 15) & ~15; }

// v as bf16 hi + lo: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

__device__ __forceinline__ void store_split2(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, int off,
                                             float v0, float v1) {
  __nv_bfloat162 h, l;
  split(v0, h.x, l.x);
  split(v1, h.y, l.y);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) = l;
}

// rows [s0, s0 + Q) of a (B,S,*,W) bf16 tensor at (b, slot) into a 64-row
// tile of width TW (row stride ld) as it is, zeros past Q, S and W; 16-byte
// cp.async where `vec` allows (call cp_async_wait_all before reading)
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, int TW,
                                          const __nv_bfloat16* src,
                                          const long long* st, int b,
                                          int slot, int s0, int Q, int W,
                                          int S, bool vec) {
  const __nv_bfloat16* base = src + b * st[0] + slot * st[2];
  const int per_row = TW / 8;
  for (int i = threadIdx.x; i < TQ * per_row; i += THREADS) {
    const int t = i / per_row, k = (i % per_row) * 8, s = s0 + t;
    __nv_bfloat16* out = dst + t * ld + k;
    const bool row = t < Q && s < S;
    if (vec && row && k + 8 <= W) {
      cp_async16(out, base + s * st[1] + k);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = row && k + e < W ? base[s * st[1] + (k + e) * st[3]]
                                  : __float2bfloat16(0.f);
    }
  }
}

// the same rows, each scaled by scale[t] in fp32 and split into hi + lo
// tiles (64 x 64, row stride LD64)
__device__ __forceinline__ void load_scaled_split(
    __nv_bfloat16* hi, __nv_bfloat16* lo, const __nv_bfloat16* src,
    const long long* st, int b, int slot, int s0, int Q, int W, int S,
    bool vec, const float* scale) {
  const __nv_bfloat16* base = src + b * st[0] + slot * st[2];
  for (int i = threadIdx.x; i < TQ * 8; i += THREADS) {
    const int t = i / 8, k = (i % 8) * 8, s = s0 + t;
    const bool row = t < Q && s < S;
    float v[8];
    if (vec && row && k + 8 <= W) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + s * st[1] + k);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] = __low2float(p2[e]);
        v[2 * e + 1] = __high2float(p2[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = row && k + e < W
                   ? __bfloat162float(base[s * st[1] + (k + e) * st[3]])
                   : 0.f;
    }
    const float sc = scale[t];
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      store_split2(hi, lo, t * LD64 + k + e, v[e] * sc, v[e + 1] * sc);
  }
}

// a 64 x 64 bf16 tile (row stride LD64) in lo, each row t scaled by
// scale[t] in fp32, split in place into hi + lo
__device__ __forceinline__ void scale_split_tile(__nv_bfloat16* hi,
                                                 __nv_bfloat16* lo,
                                                 const float* scale) {
  for (int i = threadIdx.x; i < TQ * 8; i += THREADS) {
    const int t = i / 8, k = (i % 8) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(lo + t * LD64 + k);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float sc = scale[t];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_split2(hi, lo, t * LD64 + k + 2 * e, __low2float(p2[e]) * sc,
                   __high2float(p2[e]) * sc);
  }
}

// dt of the chunk (zeros past Q and S) and, by a warp scan on warp 0, its
// inclusive cumsum g of dt * a, exp(g), exp(g_Q - g) and w = exp(g_Q - g) dt
// over the 64-row tile; lane l owns rows 2l and 2l + 1.  Returns g_Q on
// every lane of warp 0.
__device__ __forceinline__ float tile_decays(float* sdt, float* sg, float* se,
                                             float* sdec, float* sw,
                                             const float* dt,
                                             const long long* st, int b,
                                             int h, int s0, int Q, int S,
                                             float a) {
  const int lane = threadIdx.x & 31, t0 = 2 * lane, t1 = t0 + 1;
  const float* base = dt + b * st[0] + h * st[2];
  const float d0 = t0 < Q && s0 + t0 < S ? base[(s0 + t0) * st[1]] : 0.f;
  const float d1 = t1 < Q && s0 + t1 < S ? base[(s0 + t1) * st[1]] : 0.f;
  const float a0 = d0 * a, a1 = d1 * a;
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float g0 = excl + a0, g1 = g0 + a1;
  const float gq = __shfl_sync(0xffffffffu, g1, 31);
  sdt[t0] = d0;
  sdt[t1] = d1;
  sg[t0] = g0;
  sg[t1] = g1;
  se[t0] = expf(g0);
  se[t1] = expf(g1);
  sdec[t0] = expf(gq - g0);
  sdec[t1] = expf(gq - g1);
  sw[t0] = sdec[t0] * d0;
  sw[t1] = sdec[t1] * d1;
  return gq;
}

// (a) and (a'): one CTA per (chunk, head, batch); U_c into states, exp(g_Q)
// into chunk_decay and, for the backward (WITH_V), V_c into dstates.  Shared
// memory: the U operands, then V's (WITH_V only), then the decays
constexpr size_t STATE_SMEM_FWD =
    (2 * TILE64 + TILE128) * sizeof(__nv_bfloat16) + 5 * TQ * sizeof(float);
constexpr size_t STATE_SMEM =
    STATE_SMEM_FWD + (2 * TILE64 + TILE128) * sizeof(__nv_bfloat16);

template <bool WITH_V>
__device__ __forceinline__ void chunk_state(const MmaArgs& g,
                                            unsigned char* smem_raw) {
  __nv_bfloat16* swx_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* swx_lo = swx_hi + TILE64;    // w_s x_s, rows s
  __nv_bfloat16* sB = swx_lo + TILE64;
  __nv_bfloat16* sedy_hi = sB + TILE128;
  __nv_bfloat16* sedy_lo = sedy_hi + TILE64;  // exp(g_t) dy_t, rows t
  __nv_bfloat16* sC = sedy_lo + TILE64;
  float* sdt = reinterpret_cast<float*>(WITH_V ? sC + TILE128 : sedy_hi);
  float* sg = sdt + TQ;
  float* se = sg + TQ;
  float* sdec = se + TQ;
  float* sw = sdec + TQ;

  const Dims& d = g.d;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G), s0 = c * d.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bhc = ((size_t)b * d.H + h) * d.nc + c;

  load_tile(sB, LD128, 128, g.bm, g.st.bm, b, grp, s0, d.Q, d.N, d.S,
            g.vec & VEC_B);
  if (WITH_V)
    load_tile(sC, LD128, 128, g.cm, g.st.cm, b, grp, s0, d.Q, d.N, d.S,
              g.vec & VEC_C);
  else  // x as it is, in flight while warp 0 computes the decays
    load_tile(swx_lo, LD64, 64, g.x, g.st.x, b, h, s0, d.Q, d.P, d.S,
              g.vec & VEC_X);
  if (warp == 0) {
    const float gq = tile_decays(sdt, sg, se, sdec, sw, g.dt, g.st.dt, b, h,
                                 s0, d.Q, d.S, g.A[h]);
    if (lane == 0) g.chunk_decay[bhc] = expf(gq);
  }
  if (!WITH_V) cp_async_wait_all();
  __syncthreads();
  if (WITH_V) {
    load_scaled_split(swx_hi, swx_lo, g.x, g.st.x, b, h, s0, d.Q, d.P, d.S,
                      g.vec & VEC_X, sw);
    load_scaled_split(sedy_hi, sedy_lo, g.dy, g.st.dy, b, h, s0, d.Q, d.P,
                      d.S, g.vec & VEC_DY, se);
  } else {
    scale_split_tile(swx_hi, swx_lo, sw);
  }
  cp_async_wait_all();
  __syncthreads();

  // U = (w x)^T B and V = (e dy)^T C: rows p, columns n, depth the chunk
  const int m0 = (warp & 3) * 16, kq = up16(d.Q);
  const int gr = lane >> 2, gc = lane & 3;
  const size_t base = bhc * d.P * d.N;
  for (int which = 0; which < (WITH_V ? 2 : 1); ++which) {
    const __nv_bfloat16* ahi = which ? sedy_hi : swx_hi;
    const __nv_bfloat16* alo = which ? sedy_lo : swx_lo;
    const __nv_bfloat16* bb = which ? sC : sB;
    float* out = (which ? g.dstates : g.states) + base;
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * 64 + (warp >> 2) * 32;
      if (m0 >= d.P || n0 >= d.N) continue;
      float acc[4][4];
      zero(acc);
      warp_mma<true, true>(acc, ahi, LD64, bb, LD128, m0, n0, 0, kq);
      warp_mma<true, true>(acc, alo, LD64, bb, LD128, m0, n0, 0, kq);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int p = m0 + gr + 8 * (i >> 1), n = n0 + 8 * j + 2 * gc;
          if (p >= d.P || n >= d.N) continue;
          float* o = out + (size_t)p * d.N + n;
          if ((d.N & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[j][i], acc[j][i + 1]);
          } else {
            o[0] = acc[j][i];
            if (n + 1 < d.N) o[1] = acc[j][i + 1];
          }
        }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_chunk_state_kernel(MmaArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  chunk_state<true>(g, smem_raw);
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_chunk_state_kernel(MmaArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  chunk_state<false>(g, smem_raw);
}

// *p <- run, run <- q run + (old *p), for the VEC entries of one V
template <int VEC, typename V>
__device__ __forceinline__ void pass_step(V* p, const V& t, float (&run)[VEC],
                                          float q) {
  const float* tf = reinterpret_cast<const float*>(&t);
  V o;
  float* of = reinterpret_cast<float*>(&o);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    of[e] = run[e];
    run[e] = q * run[e] + tf[e];
  }
  *p = o;
}

// (b) and (b'), per state entry (VEC consecutive entries a thread): U -> S
// forward (S_c = exp(g_Q,c-1) S_c-1 + U_c-1, S_0 = 0) and, for the
// backward (DS), V -> dS in reverse (dS_c = exp(g_Q,c+1) dS_c+1 + V_c+1, 0
// for the last chunk), both walks in one loop; each thread loads AHEAD
// chunks (of both walks) before it stores, so that enough loads are in
// flight to fill the memory's bandwidth (16 a thread spill in the forward)
template <int VEC, bool DS>
__device__ __forceinline__ void state_pass(
    float* __restrict__ states, float* __restrict__ dstates,
    const float* __restrict__ chunk_decay, const Dims& d) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  constexpr int AHEAD = DS ? 8 : 12;
  const long long per_bh = (long long)d.P * d.N / VEC;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)d.B * d.H * per_bh) return;
  const long long bh = idx / per_bh, j = idx % per_bh;
  V* u = reinterpret_cast<V*>(states) + bh * d.nc * per_bh + j;
  V* v = DS ? reinterpret_cast<V*>(dstates) + bh * d.nc * per_bh + j
            : nullptr;
  const float* dec = chunk_decay + bh * d.nc;
  float s[VEC], r[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = r[e] = 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += AHEAD) {
    V tu[AHEAD], tv[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < d.nc) {
        tu[k] = u[(c0 + k) * per_bh];
        if (DS) tv[k] = v[(d.nc - 1 - c0 - k) * per_bh];
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < d.nc) {
        const int cf = c0 + k, cr = d.nc - 1 - cf;
        pass_step<VEC>(u + cf * per_bh, tu[k], s, dec[cf]);
        if (DS) pass_step<VEC>(v + cr * per_bh, tv[k], r, dec[cr]);
      }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_state_pass_kernel(float* __restrict__ states,
                          float* __restrict__ dstates,
                          const float* __restrict__ chunk_decay, Dims d) {
  state_pass<VEC, true>(states, dstates, chunk_decay, d);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_state_pass_kernel(float* __restrict__ states,
                          const float* __restrict__ chunk_decay, Dims d) {
  state_pass<VEC, false>(states, nullptr, chunk_decay, d);
}

// fp32 (P,N) rows [0, 64) x columns [n0, n0 + 64) of a state into hi + lo
// tiles (zeros past P and N) and, for the backward (DS), of its gradient;
// returns this thread's share of sum S * dS over them (0 without DS)
template <bool DS>
__device__ __forceinline__ float load_state_halves(
    __nv_bfloat16* s_hi, __nv_bfloat16* s_lo, __nv_bfloat16* ds_hi,
    __nv_bfloat16* ds_lo, const float* S, const float* dS, int P, int N,
    int n0) {
  float dot = 0.f;
  const bool vec = (N & 3) == 0;
  for (int i = threadIdx.x; i < 64 * 16; i += THREADS) {
    const int p = i / 16, j = (i % 16) * 4, n = n0 + j;
    float sv[4], dv[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec && p < P && n + 4 <= N) {
      const float4 a = *reinterpret_cast<const float4*>(S + p * N + n);
      sv[0] = a.x; sv[1] = a.y; sv[2] = a.z; sv[3] = a.w;
      if (DS) {
        const float4 b = *reinterpret_cast<const float4*>(dS + p * N + n);
        dv[0] = b.x; dv[1] = b.y; dv[2] = b.z; dv[3] = b.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = p < P && n + e < N;
        sv[e] = in ? S[p * N + n + e] : 0.f;
        if (DS) dv[e] = in ? dS[p * N + n + e] : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      store_split2(s_hi, s_lo, p * LD64 + j + e, sv[e], sv[e + 1]);
      if (DS) {
        dot += sv[e] * dv[e] + sv[e + 1] * dv[e + 1];
        store_split2(ds_hi, ds_lo, p * LD64 + j + e, dv[e], dv[e + 1]);
      }
    }
  }
  return dot;
}

// out[row, col..col+3] = v over a (rows, N) fp32 buffer: one 16-byte
// vector store where N allows it, else four scalar ones
__device__ __forceinline__ void store4(float* out, size_t row_off, int col,
                                       int N, float v0, float v1, float v2,
                                       float v3) {
  float* p = out + row_off + col;
  if ((N & 3) == 0) {
    if (col < N) *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
  } else {
    if (col < N) p[0] = v0;
    if (col + 1 < N) p[1] = v1;
    if (col + 2 < N) p[2] = v2;
    if (col + 3 < N) p[3] = v3;
  }
}

// acc (a warp's 16 x 32 tile at rows m0, columns n0 of a chunk) stored
// into rows s0 + m of this head's (B,S,H,N) fp32 terms (every element by
// one warp of one CTA): lanes c and c ^ 1 swap halves so that each holds 4
// consecutive columns of one row
__device__ __forceinline__ void store_tile(float* out, size_t rows_base,
                                           size_t row_stride, int s0, int Q,
                                           int S, int N, int m0, int n0,
                                           const float (&acc)[4][4]) {
#ifdef SSD_BWD_NO_ADDS
  // built so only to time the kernel without these stores: the sums are
  // still computed, and never stored
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += acc[j][i];
  if (sum == 3.0e38f) out[rows_base] = sum;
#else
  const int lane = threadIdx.x & 31, gr = lane >> 2, gc = lane & 3;
  const bool odd = gc & 1;
  const int m = m0 + gr + (odd ? 8 : 0);
  const bool row_ok = m < Q && s0 + m < S;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
    const int col = n0 + 8 * j + 2 * (gc & ~1);
    if (!row_ok) continue;
    const size_t off = rows_base + (size_t)(s0 + m) * row_stride;
    if (odd)
      store4(out, off, col, N, x0, x1, acc[j][2], acc[j][3]);
    else
      store4(out, off, col, N, acc[j][0], acc[j][1], x0, x1);
  }
#endif
}

// (c) one CTA per (chunk, head, batch): the chunk's gradients from its
// start state S_c and end-state gradient dS_c
constexpr size_t GRAD_SMEM =
    (2 * TILE64 + 2 * TILE128 + 6 * TILE64) * sizeof(__nv_bfloat16) +
    (6 * TQ + 2 * TQ + 4 * TQ + 2 * TQ + 4 * TQ + THREADS / 32) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_chunk_grad_kernel(MmaArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdy = sx + TILE64;
  __nv_bfloat16* sB = sdy + TILE64;
  __nv_bfloat16* sC = sB + TILE128;
  __nv_bfloat16* sS_hi = sC + TILE128;  // rows p, 64 columns of N
  __nv_bfloat16* sS_lo = sS_hi + TILE64;
  __nv_bfloat16* sdS_hi = sS_lo + TILE64;
  __nv_bfloat16* sdS_lo = sdS_hi + TILE64;
  __nv_bfloat16* sMW_hi = sdS_lo + TILE64;  // M, then W: rows t, columns s
  __nv_bfloat16* sMW_lo = sMW_hi + TILE64;
  float* sdt = reinterpret_cast<float*>(sMW_lo + TILE64);
  float* sg = sdt + TQ;
  float* se = sg + TQ;
  float* sdec = se + TQ;
  float* sw = sdec + TQ;
  float* sdiag = sw + TQ;     // Z_tt
  float* srow = sdiag + TQ;   // [2][TQ] sum_{s<t} Z_ts dt_s, by column half
  float* scol = srow + 2 * TQ;  // [4][TQ] sum_{t>s} Z_ts, by row block
  float* su = scol + 4 * TQ;    // [2][TQ] x_s . (dS B_s), by column half
  float* sv = su + 2 * TQ;      // [4][TQ] exp(g_t) dy_t . (S C_t), by half
  float* sred = sv + 4 * TQ;    // [8] sum dS * S, by warp

  const Dims& d = g.d;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G), s0 = c * d.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int m0 = wr * 16, n0 = wc * 32;
  const int kq = up16(d.Q), kp = up16(d.P), kn = up16(d.N);
  const float a = g.A[h];
  const size_t bhc = ((size_t)b * d.H + h) * d.nc + c;

  load_tile(sx, LD64, 64, g.x, g.st.x, b, h, s0, d.Q, d.P, d.S,
            g.vec & VEC_X);
  load_tile(sdy, LD64, 64, g.dy, g.st.dy, b, h, s0, d.Q, d.P, d.S,
            g.vec & VEC_DY);
  load_tile(sB, LD128, 128, g.bm, g.st.bm, b, grp, s0, d.Q, d.N, d.S,
            g.vec & VEC_B);
  load_tile(sC, LD128, 128, g.cm, g.st.cm, b, grp, s0, d.Q, d.N, d.S,
            g.vec & VEC_C);
  if (warp == 0)
    tile_decays(sdt, sg, se, sdec, sw, g.dt, g.st.dt, b, h, s0, d.Q, d.S, a);
  cp_async_wait_all();
  __syncthreads();

  // 1. G = C B^T, D = dy x^T on this warp's tile (rows t, columns s); then
  // M = G L dt_s into shared memory, W = L dt_s D kept in registers, and
  // the row, column and diagonal sums of Z = G L D
  float W[4][4];
  {
    float G[4][4], D[4][4];
    zero(G);
    zero(D);
    if (n0 <= m0 + 15) {  // else the tile lies above the diagonal: zeros
      warp_mma<false, false>(G, sC, LD128, sB, LD128, m0, n0, 0, kn);
      warp_mma<false, false>(D, sdy, LD64, sx, LD64, m0, n0, 0, kp);
    }
    float rowp[2] = {0.f, 0.f}, colp[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      colp[j][0] = colp[j][1] = 0.f;
      float mv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = m0 + gr + 8 * (i >> 1), s = n0 + 8 * j + 2 * gc + (i & 1);
        float l = 0.f;
        if (t >= s) l = expf(sg[t] - sg[s]);
        mv[i] = G[j][i] * l * sdt[s];
        W[j][i] = l * sdt[s] * D[j][i];
        const float z = G[j][i] * l * D[j][i];
        if (t == s) sdiag[t] = z;
        if (t > s) {
          rowp[i >> 1] += z * sdt[s];
          colp[j][i & 1] += z;
        }
      }
      store_split2(sMW_hi, sMW_lo, (m0 + gr) * LD64 + n0 + 8 * j + 2 * gc,
                   mv[0], mv[1]);
      store_split2(sMW_hi, sMW_lo, (m0 + gr + 8) * LD64 + n0 + 8 * j + 2 * gc,
                   mv[2], mv[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // over the 4 lanes of a row
      rowp[i] += __shfl_xor_sync(0xffffffffu, rowp[i], 1);
      rowp[i] += __shfl_xor_sync(0xffffffffu, rowp[i], 2);
    }
    if (gc == 0) {
      srow[wc * TQ + m0 + gr] = rowp[0];
      srow[wc * TQ + m0 + gr + 8] = rowp[1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // over the 8 lanes of a column
        float v = colp[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gr == 0) scol[wr * TQ + n0 + 8 * j + 2 * gc + e] = v;
      }
  }
  __syncthreads();

  // 2. dx_s = sum_t M_ts dy_t (+ w_s dS B_s, below): rows s, columns p
  float dx1[4][4], dx2[4][4];
  zero(dx1);
  zero(dx2);
  const bool p_tile = n0 < kp;
  if (p_tile) {
    warp_mma<true, true>(dx1, sMW_hi, LD64, sdy, LD64, m0, n0, m0, kq);
    warp_mma<true, true>(dx1, sMW_lo, LD64, sdy, LD64, m0, n0, m0, kq);
  }
  __syncthreads();  // M is no longer read
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    store_split2(sMW_hi, sMW_lo, (m0 + gr) * LD64 + n0 + 8 * j + 2 * gc,
                 W[j][0], W[j][1]);
    store_split2(sMW_hi, sMW_lo, (m0 + gr + 8) * LD64 + n0 + 8 * j + 2 * gc,
                 W[j][2], W[j][3]);
  }

  // 3. by halves of N: S_c and dS_c, then dx's state term, dB and dC
  const size_t state = bhc * d.P * d.N;
  const size_t grow = (size_t)d.H * d.N;
  const size_t gbase = ((size_t)b * d.S * d.H + h) * d.N;
  const int halves = d.N > 64 ? 2 : 1;
  float dss = 0.f;
  for (int half = 0; half < halves; ++half) {
    const int nh = half * 64;
    if (half) __syncthreads();  // the previous half is no longer read
    dss += load_state_halves<true>(sS_hi, sS_lo, sdS_hi, sdS_lo,
                                   g.states + state, g.dstates + state, d.P,
                                   d.N, nh);
    __syncthreads();
    const int kh = min(64, kn - nh);     // depth of this half
    const bool n_tile = n0 < kh;
    if (p_tile) {  // dx2 += B_half dS_half^T: rows s, columns p
      warp_mma<false, false>(dx2, sB + nh, LD128, sdS_hi, LD64, m0, n0, 0, kh);
      warp_mma<false, false>(dx2, sB + nh, LD128, sdS_lo, LD64, m0, n0, 0, kh);
    }
    {  // dB_s = sum_t W_ts C_t + w_s dS^T x_s: rows s, columns n
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      if (n_tile) {
        warp_mma<true, true>(a1, sMW_hi, LD64, sC + nh, LD128, m0, n0, m0, kq);
        warp_mma<true, true>(a1, sMW_lo, LD64, sC + nh, LD128, m0, n0, m0, kq);
        warp_mma<false, true>(a2, sx, LD64, sdS_hi, LD64, m0, n0, 0, kp);
        warp_mma<false, true>(a2, sx, LD64, sdS_lo, LD64, m0, n0, 0, kp);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a1[j][i] += sw[m0 + gr + 8 * (i >> 1)] * a2[j][i];
      if (n_tile)
        store_tile(g.dB, gbase, grow, s0, d.Q, d.S, d.N, m0, nh + n0, a1);
    }
    {  // dC_t = sum_s W_ts B_s + exp(g_t) S^T dy_t: rows t, columns n;
       // v_t = C_t . exp(g_t) S^T dy_t
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      if (n_tile) {
        const int ks = min(m0 + 16, kq);
        warp_mma<false, true>(a1, sMW_hi, LD64, sB + nh, LD128, m0, n0, 0, ks);
        warp_mma<false, true>(a1, sMW_lo, LD64, sB + nh, LD128, m0, n0, 0, ks);
        warp_mma<false, true>(a2, sdy, LD64, sS_hi, LD64, m0, n0, 0, kp);
        warp_mma<false, true>(a2, sdy, LD64, sS_lo, LD64, m0, n0, 0, kp);
      }
      float vp[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = m0 + gr + 8 * (i >> 1);
          const int n = n0 + 8 * j + 2 * gc + (i & 1);
          const float off = se[t] * a2[j][i];
          vp[i >> 1] += __bfloat162float(sC[t * LD128 + nh + n]) * off;
          a1[j][i] += off;
        }
      if (n_tile)
        store_tile(g.dC, gbase, grow, s0, d.Q, d.S, d.N, m0, nh + n0, a1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        vp[i] += __shfl_xor_sync(0xffffffffu, vp[i], 1);
        vp[i] += __shfl_xor_sync(0xffffffffu, vp[i], 2);
      }
      if (gc == 0) {
        sv[(2 * half + wc) * TQ + m0 + gr] = vp[0];
        sv[(2 * half + wc) * TQ + m0 + gr + 8] = vp[1];
      }
    }
  }

  // 4. dx = dx1 + w_s dx2 and u_s = x_s . dx2
  {
    float up[2] = {0.f, 0.f};
    __nv_bfloat16* out = g.dx + ((size_t)b * d.S * d.H + h) * d.P;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int s = m0 + gr + 8 * (i >> 1), p = n0 + 8 * j + 2 * gc;
        up[i >> 1] += __bfloat162float(sx[s * LD64 + p]) * dx2[j][i] +
                      __bfloat162float(sx[s * LD64 + p + 1]) * dx2[j][i + 1];
        if (s < d.Q && s0 + s < d.S && p < d.P) {
          const float v0 = dx1[j][i] + sw[s] * dx2[j][i];
          const float v1 = dx1[j][i + 1] + sw[s] * dx2[j][i + 1];
          __nv_bfloat16* o = out + (size_t)(s0 + s) * d.H * d.P + p;
          if ((d.P & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (p + 1 < d.P) o[1] = __float2bfloat16(v1);
          }
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      up[i] += __shfl_xor_sync(0xffffffffu, up[i], 1);
      up[i] += __shfl_xor_sync(0xffffffffu, up[i], 2);
    }
    if (gc == 0) {
      su[wc * TQ + m0 + gr] = up[0];
      su[wc * TQ + m0 + gr + 8] = up[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dss += __shfl_xor_sync(0xffffffffu, dss, o);
    if (lane == 0) sred[warp] = dss;
  }
  __syncthreads();

  // 5. warp 0: dg without the terms that cancel; d(dt a) as its reverse
  // cumsum plus the forward prefix of w u (see the top); ddt; da partial
  if (warp == 0) {
    const int t0 = 2 * lane, t1 = t0 + 1;
    float dsum = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) dsum += sred[w];
    float u[2], dg[2], cz[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + e;
      u[e] = su[t] + su[TQ + t];
      cz[e] = scol[t] + scol[TQ + t] + scol[2 * TQ + t] + scol[3 * TQ + t];
      float v = sv[t] + sv[TQ + t];
      if (halves == 2) v += sv[2 * TQ + t] + sv[3 * TQ + t];
      dg[e] = srow[t] + srow[TQ + t] - cz[e] * sdt[t] + v;
    }
    if (lane == 31) dg[1] += se[TQ - 1] * dsum;  // sum dS * S at the end
    const float wu0 = sw[t0] * u[0], wu1 = sw[t1] * u[1];
    float pre = wu0 + wu1, suf = dg[0] + dg[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float np = __shfl_up_sync(0xffffffffu, pre, o);
      const float ns = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane >= o) pre += np;
      if (lane + o < 32) suf += ns;
    }
    float before = __shfl_up_sync(0xffffffffu, pre, 1);    // rows < t0
    float after = __shfl_down_sync(0xffffffffu, suf, 1);   // rows > t1
    if (lane == 0) before = 0.f;
    if (lane == 31) after = 0.f;
    float dda[2];
    dda[1] = before + wu0 + after + dg[1];
    dda[0] = before + after + dg[1] + dg[0];
    float da = sdt[t0] * dda[0] + sdt[t1] * dda[1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) g.da_part[bhc] = da;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + e;
      if (t < d.Q && s0 + t < d.S)
        g.ddt[((size_t)b * d.S + s0 + t) * d.H + h] =
            a * dda[e] + cz[e] + sdiag[t] + sdec[t] * u[e];
    }
  }
}

// a chunk-start state (count fp32, contiguous) into shared memory as it
// is: 16-byte cp.async where count allows it (call cp_async_wait_all before
// reading)
__device__ __forceinline__ void load_state_raw(float* dst, const float* src,
                                               int count) {
  if ((count & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * THREADS)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = src[i];
  }
}

// (c') one CTA per (chunk, head, batch): y of the chunk's rows from the
// chunk's inputs and its start state S_c, which is copied into shared
// memory with the inputs and split into hi + lo there, by halves of N, in
// the buffer of M once M is read
constexpr size_t SCAN_SMEM =
    (3 * TILE64 + 2 * TILE128) * sizeof(__nv_bfloat16) +
    (MAX_P * MAX_N + 5 * TQ) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_chunk_scan_kernel(MmaArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sx + TILE64;
  __nv_bfloat16* sC = sB + TILE128;
  __nv_bfloat16* sM_hi = sC + TILE128;  // M: rows t, columns s; then S_c:
  __nv_bfloat16* sM_lo = sM_hi + TILE64;  // rows p, 64 columns of N
  float* sS = reinterpret_cast<float*>(sM_lo + TILE64);  // S_c, (P,N) fp32
  float* sdt = sS + MAX_P * MAX_N;
  float* sg = sdt + TQ;
  float* se = sg + TQ;
  float* sdec = se + TQ;
  float* sw = sdec + TQ;

  const Dims& d = g.d;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G), s0 = c * d.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const int kq = up16(d.Q), kp = up16(d.P), kn = up16(d.N);

  if (c > 0)  // S_0 = 0: chunk 0 has no state term
    load_state_raw(sS, g.states + (((size_t)b * d.H + h) * d.nc + c) * d.P *
                                      d.N, d.P * d.N);
  load_tile(sx, LD64, 64, g.x, g.st.x, b, h, s0, d.Q, d.P, d.S,
            g.vec & VEC_X);
  load_tile(sB, LD128, 128, g.bm, g.st.bm, b, grp, s0, d.Q, d.N, d.S,
            g.vec & VEC_B);
  load_tile(sC, LD128, 128, g.cm, g.st.cm, b, grp, s0, d.Q, d.N, d.S,
            g.vec & VEC_C);
  if (warp == 0)
    tile_decays(sdt, sg, se, sdec, sw, g.dt, g.st.dt, b, h, s0, d.Q, d.S,
                g.A[h]);
  cp_async_wait_all();
  __syncthreads();

  // 1. G = C B^T on this warp's tile (rows t, columns s), skipped above the
  // diagonal; M = G L dt_s into shared memory as hi + lo
  {
    float G[4][4];
    zero(G);
    if (n0 <= m0 + 15)
      warp_mma<false, false>(G, sC, LD128, sB, LD128, m0, n0, 0, kn);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = m0 + gr + 8 * (i >> 1), s = n0 + 8 * j + 2 * gc + (i & 1);
        mv[i] = t >= s ? G[j][i] * expf(sg[t] - sg[s]) * sdt[s] : 0.f;
      }
      store_split2(sM_hi, sM_lo, (m0 + gr) * LD64 + n0 + 8 * j + 2 * gc,
                   mv[0], mv[1]);
      store_split2(sM_hi, sM_lo, (m0 + gr + 8) * LD64 + n0 + 8 * j + 2 * gc,
                   mv[2], mv[3]);
    }
  }
  __syncthreads();

  // 2. y = M x (rows t, columns p; depth up to the warp's diagonal block)
  // + exp(g_t) C S_c^T, S_c by halves of N
  float y1[4][4], y2[4][4];
  zero(y1);
  zero(y2);
  const bool p_tile = n0 < kp;
  if (p_tile) {
    const int ks = min(m0 + 16, kq);
    warp_mma<false, true>(y1, sM_hi, LD64, sx, LD64, m0, n0, 0, ks);
    warp_mma<false, true>(y1, sM_lo, LD64, sx, LD64, m0, n0, 0, ks);
  }
  if (c > 0) {
    const int halves = d.N > 64 ? 2 : 1;
    for (int half = 0; half < halves; ++half) {
      const int nh = half * 64;
      __syncthreads();  // M, then the previous half, is no longer read
      load_state_halves<false>(sM_hi, sM_lo, nullptr, nullptr, sS, nullptr,
                               d.P, d.N, nh);
      __syncthreads();
      const int kh = min(64, kn - nh);     // depth of this half
      if (p_tile) {
        warp_mma<false, false>(y2, sC + nh, LD128, sM_hi, LD64, m0, n0, 0,
                               kh);
        warp_mma<false, false>(y2, sC + nh, LD128, sM_lo, LD64, m0, n0, 0,
                               kh);
      }
    }
  }

  // 3. the chunk's rows of y, each written once
  __nv_bfloat16* out = g.y + ((size_t)b * d.S * d.H + h) * d.P;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int t = m0 + gr + 8 * (i >> 1), p = n0 + 8 * j + 2 * gc;
      if (t >= d.Q || s0 + t >= d.S || p >= d.P) continue;
      const float v0 = y1[j][i] + se[t] * y2[j][i];
      const float v1 = y1[j][i + 1] + se[t] * y2[j][i + 1];
      __nv_bfloat16* o = out + (size_t)(s0 + t) * d.H * d.P + p;
      if ((d.P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (p + 1 < d.P) o[1] = __float2bfloat16(v1);
      }
    }
}

bool dims_ok(const Dims& d) {
  return d.B > 0 && d.S > 0 && d.H > 0 && d.G > 0 && d.H % d.G == 0 &&
         d.Q > 0 && d.Q <= MAX_Q &&
         d.P > 0 && d.P <= MAX_P && d.N > 0 && d.N <= MAX_N &&
         d.nc == (d.S + d.Q - 1) / d.Q;
}

Strides unpack(const long long* s) {
  Strides st;
  for (int i = 0; i < 4; ++i) st.x[i] = s[i];
  for (int i = 0; i < 3; ++i) st.dt[i] = s[4 + i];
  for (int i = 0; i < 4; ++i) st.bm[i] = s[7 + i];
  for (int i = 0; i < 4; ++i) st.cm[i] = s[11 + i];
  for (int i = 0; i < 4; ++i) st.dy[i] = s[15 + i];
  return st;
}

cudaError_t launch_fwd_fp32(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, void* y, Dims d,
                            Strides st, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<<<d.B * d.H, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), d, st);
  return cudaGetLastError();
}

cudaError_t launch_bwd_fp32(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, const void* dy,
                            void* dx, void* ddt, void* da_part, void* dB,
                            void* dC, void* states, Dims d, Strides st,
                            cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<<<d.B * d.H, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dy),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(da_part), static_cast<float*>(dB),
      static_cast<float*>(dC),
      static_cast<float*>(states), d, st);
  return cudaGetLastError();
}

// rows of a (B,S,slots,W) bf16 tensor can be read 16 bytes at once: the
// last dimension is contiguous and every row starts 16-byte aligned
bool rows_16b(const void* p, const long long* st, int B, int S, int slots) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[3] == 1 &&
         (B == 1 || st[0] % 8 == 0) && (S == 1 || st[1] % 8 == 0) &&
         (slots == 1 || st[2] % 8 == 0);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// launch the bf16 state pass on states (and, with dstates, the backward's
// reverse pass on dstates): VEC 4 entries a thread where P*N allows it
cudaError_t launch_state_pass(float* states, float* dstates,
                              const float* chunk_decay, const Dims& d,
                              cudaStream_t stream) {
  const int vec = (d.P * d.N) % 4 == 0 ? 4 : 1;
  const long long threads = (long long)d.B * d.H * d.P * d.N / vec;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (dstates && vec == 4)
    ssd_bwd_state_pass_kernel<4><<<blocks, THREADS, 0, stream>>>(
        states, dstates, chunk_decay, d);
  else if (dstates)
    ssd_bwd_state_pass_kernel<1><<<blocks, THREADS, 0, stream>>>(
        states, dstates, chunk_decay, d);
  else if (vec == 4)
    ssd_fwd_state_pass_kernel<4><<<blocks, THREADS, 0, stream>>>(
        states, chunk_decay, d);
  else
    ssd_fwd_state_pass_kernel<1><<<blocks, THREADS, 0, stream>>>(
        states, chunk_decay, d);
  return cudaGetLastError();
}

// the bf16 forward: (a'), (b'), (c') in turn on `stream`; work holds the
// states (B*H*nc*P*N fp32) and then the chunk decays (B*H*nc fp32)
cudaError_t launch_fwd_bf16(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, void* y,
                            void* work, Dims d, Strides st,
                            cudaStream_t stream) {
  const long long entries = (long long)d.B * d.H * d.nc * d.P * d.N;
  MmaArgs g = {};
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.bm = static_cast<const __nv_bfloat16*>(bm);
  g.cm = static_cast<const __nv_bfloat16*>(cm);
  g.dt = static_cast<const float*>(dt);
  g.A = static_cast<const float*>(A);
  g.y = static_cast<__nv_bfloat16*>(y);
  g.states = static_cast<float*>(work);
  g.chunk_decay = g.states + entries;
  g.d = d;
  g.st = st;
  g.vec = (rows_16b(x, st.x, d.B, d.S, d.H) ? VEC_X : 0) |
          (rows_16b(bm, st.bm, d.B, d.S, d.G) ? VEC_B : 0) |
          (rows_16b(cm, st.cm, d.B, d.S, d.G) ? VEC_C : 0);
  cudaError_t err = allow_smem(ssd_fwd_chunk_state_kernel, STATE_SMEM_FWD);
  if (err == cudaSuccess)
    err = allow_smem(ssd_fwd_chunk_scan_kernel, SCAN_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.nc, d.H, d.B);
  ssd_fwd_chunk_state_kernel<<<grid, THREADS, STATE_SMEM_FWD, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_state_pass(g.states, nullptr, g.chunk_decay, d, stream);
  if (err != cudaSuccess) return err;
  ssd_fwd_chunk_scan_kernel<<<grid, THREADS, SCAN_SMEM, stream>>>(g);
  return cudaGetLastError();
}

// the bf16 backward: (a), (b), (c) in turn on `stream`; work holds dS
// (B*H*nc*P*N fp32) and then the chunk decays (B*H*nc fp32)
cudaError_t launch_bwd_bf16(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, const void* dy,
                            void* dx, void* ddt, void* da_part, void* dB,
                            void* dC, void* states, void* work, Dims d,
                            Strides st, cudaStream_t stream) {
  const long long entries = (long long)d.B * d.H * d.nc * d.P * d.N;
  MmaArgs g;
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.bm = static_cast<const __nv_bfloat16*>(bm);
  g.cm = static_cast<const __nv_bfloat16*>(cm);
  g.dy = static_cast<const __nv_bfloat16*>(dy);
  g.dt = static_cast<const float*>(dt);
  g.A = static_cast<const float*>(A);
  g.dx = static_cast<__nv_bfloat16*>(dx);
  g.ddt = static_cast<float*>(ddt);
  g.da_part = static_cast<float*>(da_part);
  g.dB = static_cast<float*>(dB);
  g.dC = static_cast<float*>(dC);
  g.states = static_cast<float*>(states);
  g.dstates = static_cast<float*>(work);
  g.chunk_decay = g.dstates + entries;
  g.d = d;
  g.st = st;
  g.vec = (rows_16b(x, st.x, d.B, d.S, d.H) ? VEC_X : 0) |
          (rows_16b(dy, st.dy, d.B, d.S, d.H) ? VEC_DY : 0) |
          (rows_16b(bm, st.bm, d.B, d.S, d.G) ? VEC_B : 0) |
          (rows_16b(cm, st.cm, d.B, d.S, d.G) ? VEC_C : 0);
  cudaError_t err = allow_smem(ssd_bwd_chunk_state_kernel, STATE_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_chunk_grad_kernel, GRAD_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.nc, d.H, d.B);
  ssd_bwd_chunk_state_kernel<<<grid, THREADS, STATE_SMEM, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_state_pass(g.states, g.dstates, g.chunk_decay, d, stream);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_grad_kernel<<<grid, THREADS, GRAD_SMEM, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, y and dx); dt, A, ddt,
// da_part, dB, dC, states and work are fp32.  Bm and Cm hold G groups (G divides
// H).  strides: 19 element strides, (b, s, h, p) of x, (b, s, h) of dt,
// (b, s, g, n) of Bm and Cm, (b, s, h, p) of dy (ignored by the forward).
// Outputs are contiguous: y, dx (B,S,H,P); ddt (B,S,H); da_part (B,H); dB
// and dC (B,S,H,N), each head's terms, every element written (the caller
// sums the heads of a group).  Returns the CUDA error of the launch (0 on
// success).
// work: for bf16, B*H*nc*P*N + B*H*nc fp32 of scratch (the chunk-start
// states and the chunk decays); for float32 it is unused.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, void* y,
                            void* work, int B, int S, int H, int G, int P,
                            int N, int Q, int dtype, const long long* strides,
                            void* stream) {
  const Dims d{B, S, H, G, P, N, Q, (S + Q - 1) / Q};
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && work != nullptr)
    return launch_fwd_bf16(x, dt, A, bm, cm, y, work, d, st, s);
  if (dtype == 0) return launch_fwd_fp32(x, dt, A, bm, cm, y, d, st, s);
  return (int)cudaErrorInvalidValue;
}

// work: for bf16, B*H*nc*P*N + B*H*nc fp32 of scratch (dS and the chunk
// decays), and da_part is (B,H,nc); for float32 it is unused and da_part
// is (B,H).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, const void* dy,
                            void* dx, void* ddt, void* da_part, void* dB,
                            void* dC, void* states, void* work, int B, int S,
                            int H, int G, int P, int N, int Q, int dtype,
                            const long long* strides, void* stream) {
  const Dims d{B, S, H, G, P, N, Q, (S + Q - 1) / Q};
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && work != nullptr)
    return launch_bwd_bf16(x, dt, A, bm, cm, dy, dx, ddt, da_part, dB, dC,
                           states, work, d, st, s);
  if (dtype == 0)
    return launch_bwd_fp32(x, dt, A, bm, cm, dy, dx, ddt, da_part, dB, dC,
                           states, d, st, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs per SM that the bf16 backward's three kernels reach (chunk state,
// state pass with 4 entries a thread, chunk grad) into blocks[0..2].
// Returns the CUDA error (0 on success).
extern "C" int ssd_scan_bwd_occupancy(int* blocks) {
  cudaError_t err = allow_smem(ssd_bwd_chunk_state_kernel, STATE_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_chunk_grad_kernel, GRAD_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_bwd_chunk_state_kernel, THREADS, STATE_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, ssd_bwd_state_pass_kernel<4>, THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, ssd_bwd_chunk_grad_kernel, THREADS, GRAD_SMEM);
  return (int)err;
}

// CTAs per SM that the bf16 forward's three kernels reach (chunk state,
// state pass with 4 entries a thread, chunk scan) into blocks[0..2].
// Returns the CUDA error (0 on success).
extern "C" int ssd_scan_fwd_occupancy(int* blocks) {
  cudaError_t err = allow_smem(ssd_fwd_chunk_state_kernel, STATE_SMEM_FWD);
  if (err == cudaSuccess)
    err = allow_smem(ssd_fwd_chunk_scan_kernel, SCAN_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_fwd_chunk_state_kernel, THREADS, STATE_SMEM_FWD);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, ssd_fwd_state_pass_kernel<4>, THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, ssd_fwd_chunk_scan_kernel, THREADS, SCAN_SMEM);
  return (int)err;
}
