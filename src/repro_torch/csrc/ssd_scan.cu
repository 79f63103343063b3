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
// The backward (kernel 2) recomputes the chunk-start states in a forward
// walk into a transient buffer, then walks the chunks in reverse carrying
// dS, the gradient of the state at the chunk's end:
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
// -w_s u_s at s, so d(dt*a)_t gets sum_{s<t} w_s u_s, a forward prefix).  dB and dC are summed over the heads of a group
// in fp32 with atomicAdd into zeroed (B,S,G,N) fp32 buffers, which the
// wrapper rounds once to x's dtype; the order of the adds varies from run
// to run, so their last fp32 bits may too.  da is written per (batch, head)
// as fp32 partials that the wrapper sums over the batch in a fixed order.
//
// What bounds it on the H100: at the training shape (B 8, S 2048, H 32,
// P 64, N 128, Q 64) the forward moves about 144 MB (bf16 x, y, B, C, fp32
// dt): 43 us by bytes.  Its 30 GFLOP would take 30 us at the bf16
// tensor-core peak but 0.45 ms at the fp32 FMA peak that this version runs
// at, so here the operations bound it.  This first version keeps every
// operand of a chunk in shared memory (fp32, rows padded to an odd stride
// so that row and column reads are free of bank conflicts) and runs the
// chunk's products as register-tiled FMA loops: 256 threads in a 16 x 16
// layout, each owning up to 4 x 8 outputs, loading 12 operands for 32 FMAs.
// One CTA per (batch, head) walks its chunks in order, the (P,N) state in
// shared memory, so the grid is B*H CTAs.  Tensor cores (mma.sync/wgmma in
// bf16 or tf32) and splitting the sequence across CTAs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 layout of output micro-tiles
constexpr int MAX_Q = 64;     // rows of a micro-tiled product: <= 4 * 16
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;    // columns: <= 8 * 16

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const long long* st, int b, int h,
                                          int s0, int Q, int W, int S) {
  const T* base = src + b * st[0] + h * st[2];
  for (int i = threadIdx.x; i < Q * W; i += THREADS) {
    const int t = i / W, w = i % W;
    const int s = s0 + t;
    dst[t * (W + 1) + w] = s < S ? to_float(base[s * st[1] + w * st[3]]) : 0.f;
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
// forward: one CTA per (batch, head)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ bm,
               const T* __restrict__ cm, T* __restrict__ y, Dims d,
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
      T* yb = y + ((size_t)b * d.S * d.H + h) * P;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = ty + 16 * ii, p = tx + 16 * jj;
          if (t < Q && p < P && s0 + t < d.S)
            yb[(size_t)(s0 + t) * d.H * P + p] =
                from_float<T>(yd[ii][jj] + seg[t] * yo[ii][jj]);
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
// dB and dC are zeroed (B,S,G,N) fp32 accumulators
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ bm,
               const T* __restrict__ cm, const T* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ ddt,
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
    // this head's rows of the (B,S,G,N) dB and dC accumulators
    const size_t grow = (size_t)d.G * N;
    const size_t gbase = ((size_t)b * d.S * d.G + grp) * N;
    {  // dx_s = sum_t M_ts dy_t + w_s dS B_s;  u_s = x_s . (dS B_s)
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      mm_acc(a1, sM, 1, Q + 1, sdy, P + 1, 1, Q, P, Q, nullptr);
      mm_acc(a2, sB, N + 1, 1, sdS, 1, N + 1, Q, P, N, nullptr);
      T* out = dx + ((size_t)b * d.S * d.H + h) * P;
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
                  from_float<T>(a1[ii][jj] + sw[s] * a2[ii][jj]);
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
            atomicAdd(out + (size_t)(s0 + s) * grow + n,
                      a1[ii][jj] + sw[s] * a2[ii][jj]);
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
              atomicAdd(out + (size_t)(s0 + t) * grow + n, a1[ii][jj] + off);
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

template <typename T>
cudaError_t launch_fwd(const void* x, const void* dt, const void* A,
                       const void* bm, const void* cm, void* y, Dims d,
                       Strides st, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<T><<<d.B * d.H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), d, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* bm, const void* cm, const void* dy,
                       void* dx, void* ddt, void* da_part, void* dB, void* dC,
                       void* states, Dims d, Strides st,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T><<<d.B * d.H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(da_part), static_cast<float*>(dB),
      static_cast<float*>(dC),
      static_cast<float*>(states), d, st);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, y and dx); dt, A, ddt,
// da_part, dB, dC and states are fp32.  Bm and Cm hold G groups (G divides
// H).  strides: 19 element strides, (b, s, h, p) of x, (b, s, h) of dt,
// (b, s, g, n) of Bm and Cm, (b, s, h, p) of dy (ignored by the forward).
// Outputs are contiguous: y, dx (B,S,H,P); ddt (B,S,H); da_part (B,H); dB
// and dC (B,S,G,N), zeroed by the caller.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, void* y, int B,
                            int S, int H, int G, int P, int N, int Q,
                            int dtype, const long long* strides,
                            void* stream) {
  const Dims d{B, S, H, G, P, N, Q, (S + Q - 1) / Q};
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, dt, A, bm, cm, y, d, st, s);
  if (dtype == 0) return launch_fwd<float>(x, dt, A, bm, cm, y, d, st, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* bm, const void* cm, const void* dy,
                            void* dx, void* ddt, void* da_part, void* dB,
                            void* dC, void* states, int B, int S, int H,
                            int G, int P, int N, int Q, int dtype,
                            const long long* strides, void* stream) {
  const Dims d{B, S, H, G, P, N, Q, (S + Q - 1) / Q};
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dt, A, bm, cm, dy, dx, ddt, da_part,
                                     dB, dC, states, d, st, s);
  if (dtype == 0)
    return launch_bwd<float>(x, dt, A, bm, cm, dy, dx, ddt, da_part, dB, dC,
                             states, d, st, s);
  return (int)cudaErrorInvalidValue;
}
