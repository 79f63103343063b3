// RMSNorm for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel).  Over the last axis of x, viewed as (rows, d):
//   y = x * rsqrt(mean(x^2) + eps) * w
// in fp32, cast to x's dtype.  The backward has no TPU counterpart (the JAX
// package differentiates the plain version).  With rstd recomputed from x,
// xhat = x * rstd and c = mean(xhat * w * dy):
//   dx = rstd * (w * dy - xhat * c)    in x's dtype
//   dw = sum over rows of dy * xhat    in w's dtype
// all in fp32.  x, y, dy and dx share a dtype, fp32 or bf16; w is either.
//
// What bounds it on the H100: memory.  Each element is read once and
// written once (the backward reads x and dy and writes dx) with about 4
// (forward) or 10 (backward) operations, far below the card's ~295
// operations a byte.  At the training shapes the bound is 0.02-0.06 ms: the
// backward at 4352 x 6144 (internvl2-26b) must move 160 MB, 0.048 ms at
// 3.35 TB/s.  At the decode shapes (8 rows of 2560-8192, 41-131 KB) it is
// below a microsecond, so the launch and one round trip to memory set the
// device time, and what the host spends on each call matters more than
// either.
//
// What the design does about it:
// - Forward, few rows (the serving shapes: up to 16 rows an SM), 256 < d
//   <= 2560: a CTA a row, a 16-byte vector a thread (two past 4 rows an
//   SM), so a row's loads spread over up to ten warps and each thread's
//   sums are a few terms long; the warps' sums meet once in shared memory.
// - Forward, many rows, d <= 2560: a row lives in a group's registers.  A
//   group of LANES lanes (32, or 16 at d <= 128, two rows a warp) holds a
//   row as 16-byte vectors, E elements a lane, E a template parameter, so
//   d 2560 is 10 vectors a lane with no padding to a power of two.  Each
//   group loads R rows before it reduces any.  Sums are warp shuffles.  w
//   is loaded once per warp into registers, beside the first rows.
// - Backward, d <= 2560: a persistent grid (CTAs per SM from the occupancy
//   API, times the SMs) whose warps take rows in a grid-wide stride.  Each
//   lane copies its 16-byte vectors of x and dy with cp.async into its
//   warp's ring of S rows in shared memory, S - 1 rows ahead of the row it
//   reduces (S 4 for rows up to 2 KB, else 2): at bf16 d 1024 and 2048, 8
//   warps an SM keep 96 and 64 KB of rows in flight beside the ones they
//   reduce.  A lane reads back only the vectors it copied, so the ring
//   needs no barrier.  dw for the lane's columns stays in fp32 registers
//   across the warp's rows.  At the end the warps of a CTA add theirs in
//   warp order through shared memory into one fp32 partials row per CTA,
//   and a second kernel sums the partials column by column in a fixed
//   order.  No atomics: dw is the same bits on every run.
// - Wide rows (d > 2560; qwen3-8b to qwen2-72b run 4096-8192) in both
//   directions: a row across a CTA (*_cta_kernel).  A warp a row would
//   walk 96-128 vectors a lane in turn; the looped kernels that did so read
//   each row twice, and the backward's CTAs of one warp (32 an SM, 4224 in
//   all) each kept an fp32 partials row in device memory, read and written
//   for every row: 104 MB at 4352 x 6144, 415 MB of traffic beside the 160
//   the work needs.  Here thread t holds the 16-byte vectors t + k T (k <
//   CTA_NV, T threads) of the row in registers, so a row is read once; the
//   sums go by warp shuffles, then through shared memory in warp order, and
//   every thread reads the same total.  The grid is persistent (CTAs an SM
//   from the occupancy API): CTA b takes rows b, b + G, ..., and issues the
//   next row's loads into a second set of registers before it reduces the
//   current one, so a row per CTA is always in flight.  The forward keeps
//   w's vectors in registers across its rows; at few rows (decode) its grid
//   is a CTA a row.  The backward keeps w in
//   fp32 in shared memory (converted once) and dw for its columns in fp32
//   registers, and writes one partials row a CTA at the end: 264 rows (6.5
//   MB) at d 6144, summed by the same fixed-order second kernel.  Up to
//   CTA_MAX_THREADS threads: bf16 d 16384, fp32 8192.
// - What the register bodies do not take runs looped kernels
//   (*_wide_kernel) that read a row twice: in the forward a w dtype other
//   than x's, rows whose base or pitch is not 16-byte aligned (a view at an
//   odd storage offset, bf16 d 100) and d past the cta body; in the
//   backward d past the cta body.  The backward's register and cta bodies
//   take unaligned rows in a scalar body of their own.
// - Every kernel is launched with programmatic dependent launch, so its
//   launch overlaps the end of the kernel before it (wait_prior_grid).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int FWD_THREADS = 128;
constexpr int BWD_MAX_WARPS = 8;
constexpr int MAX_E = 80;         // elements a lane of the register bodies
constexpr int SMEM_CAP = 232448;  // shared memory a CTA can use (227 KB)
constexpr int SUM_SPLIT = 32;     // warps a column block of the dw sum
constexpr int ROW_MAX_THREADS = 1024;
constexpr int CTA_NV = 4;             // 16-byte vectors a thread, cta bodies
constexpr int CTA_MAX_THREADS = 512;

// 16 bytes of T as fp32, and back (bf16: round to nearest even)
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T of_f(float v);
template <>
__device__ __forceinline__ float of_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 of_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// element j of w, bf16 or fp32 as the caller says
__device__ __forceinline__ float w_at(const void* w, int w_bf16, int j) {
  return w_bf16 ? __bfloat162float(static_cast<const bf16*>(w)[j])
                : static_cast<const float*>(w)[j];
}

// the sum over each aligned group of LANES lanes; every lane of the warp
// must call it
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's groups are still in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Programmatic dependent launch: every kernel here is launched with it
// (launch() below), so its CTAs may be scheduled while the previous kernel
// in the stream drains.  Each kernel waits for that kernel to finish, and
// for its writes to be visible, before it touches device memory; and it
// lets the next kernel's CTAs be scheduled early in turn (the forward
// kernels at their start, the backward's at their end).  What it saves is
// launch latency: at 8 rows of 2560 the forward took 0.0026 ms a call
// queued back to back without it, 0.0018 with it, on the H100.  A profiler
// books a CTA's wait for the previous kernel as time of this kernel.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void release_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// N floats from 16-byte-aligned shared memory, 16 bytes at a time
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = q.x;
    f[4 * i + 1] = q.y;
    f[4 * i + 2] = q.z;
    f[4 * i + 3] = q.w;
  }
}

// the sum of f[0..N), as a tree: N independent chains of the caller's
// products end in log2(N) adds
template <int N>
__device__ __forceinline__ float tree_sum(float* f) {
#pragma unroll
  for (int h = N / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) f[i] += f[i + h];
  }
  return f[0];
}

// rows of x and dy a backward warp holds in its ring: 4 for rows up to 2 KB
// in the register body of E elements a lane, else 2 (of 2, 3 and 4, the
// fastest on the H100 at bf16 d 1024 and 2048)
template <typename T, int E>
__host__ __device__ constexpr int stages() {
  return E * 32 * sizeof(T) <= 2048 ? 4 : 2;
}

// bytes of the backward's fp32 copy of w at the start of shared memory
__host__ __device__ __forceinline__ size_t w_bytes(int d) {
  return ((size_t)d * 4 + 15) / 16 * 16;
}

// threads of a cta body's CTA for d: CTA_NV vectors (or in the scalar body
// CTA_NV x N columns) a thread, in whole warps
template <typename T>
__host__ __device__ constexpr int cta_threads(int d) {
  return (d + 32 * CTA_NV * Vec<T>::N - 1) / (32 * CTA_NV * Vec<T>::N) * 32;
}

// whether a cta body takes d (past the register bodies, within
// CTA_MAX_THREADS threads: bf16 d 16384, fp32 8192)
template <typename T>
bool cta_takes(int d) {
  return d > 32 * MAX_E && cta_threads<T>(d) <= CTA_MAX_THREADS;
}

// v[0..K) summed over the CTA in place: each warp's sums by shuffles, then
// the warps' in warp order through red (K x 32 floats), so that every
// thread holds the same totals.  Every thread must call it; red must not be
// written again until every thread has read it (the callers alternate two
// buffers: the barrier of the call between lies in between).
template <int K>
__device__ __forceinline__ void cta_sum(float* v, float* red) {
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = group_sum<32>(v[i]);
    if (threadIdx.x % 32 == 0) red[32 * i + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float t = 0.f;
    for (int k = 0; k < warps; ++k) t += red[32 * i + k];
    v[i] = t;
  }
}

// this thread's NV vectors of a row (v = threadIdx.x + k blockDim.x), zeros
// past nvec or where the row is not `valid`; STREAM: loaded as data read
// once (ld.global.cs, evicted from the caches first)
template <int NV, bool STREAM = false>
__device__ __forceinline__ void load_vecs(const void* row, int nvec,
                                          bool valid, uint4* out) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    out[k] = !(valid && v < nvec) ? make_uint4(0u, 0u, 0u, 0u)
             : STREAM             ? __ldcs(p + v)
                                  : p[v];
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// d <= LANES * E, w in x's dtype, x, w and y 16-byte aligned and d a
// multiple of a vector.  Warp k takes rows [k RW, (k+1) RW), then every
// (warps of the grid x RW)-th block of rows; group g of the warp takes R of
// them.
template <typename T, int LANES, int E, int R>
__global__ void __launch_bounds__(FWD_THREADS)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ y, int n_rows, int d, float inv_d,
                       float eps) {
  using V = Vec<T>;
  constexpr int N = V::N, NV = E / N, RW = R * (32 / LANES);
  static_assert(E % N == 0, "E must fill whole vectors");
  const int lane = threadIdx.x % LANES;
  const int sub = (threadIdx.x % 32) / LANES;
  const long long n_warps = (long long)gridDim.x * (FWD_THREADS / 32);
  const long long warp =
      (long long)blockIdx.x * (FWD_THREADS / 32) + threadIdx.x / 32;
  release_next_grid();
  wait_prior_grid();
  const int nvec = d / N;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 wv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + k * LANES;
    wv[k] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(w) + v) : zero;
  }
  for (long long base = warp * RW; base < n_rows; base += n_warps * RW) {
    uint4 xv[R][NV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + sub * R + r;
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + k * LANES;
        xv[r][k] = row < n_rows && v < nvec ? xr[v] : zero;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + sub * R + r;
      float acc[N] = {};
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float f[N];
        V::unpack(xv[r][k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = fmaf(f[e], f[e], acc[e]);
      }
      const float rstd =
          rsqrtf(group_sum<LANES>(tree_sum<N>(acc)) * inv_d + eps);
      if (row >= n_rows) continue;
      uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + k * LANES;
        if (v < nvec) {
          float f[N], g[N];
          V::unpack(xv[r][k], f);
          V::unpack(wv[k], g);
#pragma unroll
          for (int e = 0; e < N; ++e) f[e] = f[e] * rstd * g[e];
          yr[v] = V::pack(f);
        }
      }
    }
  }
}

// few rows (the serving shapes), 256 < d <= 32 * MAX_E, w in x's dtype,
// aligned: a CTA a row, V vectors a thread, so that a row's loads spread
// over up to twenty warps and each thread's sums are short.  The warps'
// sums meet in shared memory, and every thread adds them in the same order,
// so all hold the same total.
template <typename T, int V>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
    rmsnorm_fwd_row_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           T* __restrict__ y, int d, float inv_d, float eps) {
  using Vt = Vec<T>;
  constexpr int N = Vt::N;
  __shared__ __align__(16) float part[32];
  const int nvec = d / N, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + (long long)blockIdx.x * d);
  release_next_grid();
  wait_prior_grid();
  uint4 xv[V], wv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    xv[k] = v < nvec ? xr[v] : zero;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    wv[k] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(w) + v) : zero;
  }
  float acc[N] = {};
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float f[N];
    Vt::unpack(xv[k], f);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = fmaf(f[e], f[e], acc[e]);
  }
  const float ss = group_sum<32>(tree_sum<N>(acc));
  if (lane == 0) part[threadIdx.x / 32] = ss;
  if (threadIdx.x >= warps && threadIdx.x < 32) part[threadIdx.x] = 0.f;
  __syncthreads();
  float tot = 0.f;  // the warps' sums, four at a time, in warp order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (4 * i < warps) {
      const float4 q = reinterpret_cast<const float4*>(part)[i];
      tot += (q.x + q.y) + (q.z + q.w);
    }
  }
  const float rstd = rsqrtf(tot * inv_d + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (long long)blockIdx.x * d);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    if (v < nvec) {
      float f[N], g[N];
      Vt::unpack(xv[k], f);
      Vt::unpack(wv[k], g);
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = f[e] * rstd * g[e];
      yr[v] = Vt::pack(f);
    }
  }
}

// d > 32 * MAX_E, w in x's dtype, aligned: a row across the CTA, thread t
// holding the vectors t + k blockDim.x (k < NV) of the row and of w in
// registers.  CTA b takes rows b, b + gridDim.x, ... (gridDim.x <= n_rows)
// and loads the next one before it reduces the current one.
template <typename T, int NV>
__global__ void __launch_bounds__(CTA_MAX_THREADS)
    rmsnorm_fwd_cta_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           T* __restrict__ y, int n_rows, int d, float inv_d,
                           float eps) {
  using Vt = Vec<T>;
  constexpr int N = Vt::N;
  __shared__ float red[2][32];
  const int nvec = d / N;
  release_next_grid();
  wait_prior_grid();
  uint4 xv[NV], wv[NV];
  load_vecs<NV>(x + (long long)blockIdx.x * d, nvec, true, xv);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    wv[k] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(w) + v)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  int buf = 0;
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const long long next = row + gridDim.x;
    uint4 xn[NV];
    load_vecs<NV>(x + next * d, nvec, next < n_rows, xn);
    float acc[N] = {};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[N];
      Vt::unpack(xv[k], f);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = fmaf(f[e], f[e], acc[e]);
    }
    float ss = tree_sum<N>(acc);
    cta_sum<1>(&ss, red[buf]);
    const float rstd = rsqrtf(ss * inv_d + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      if (v < nvec) {
        float f[N], g[N];
        Vt::unpack(xv[k], f);
        Vt::unpack(wv[k], g);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = f[e] * rstd * g[e];
        yr[v] = Vt::pack(f);
      }
      xv[k] = xn[k];
    }
    buf ^= 1;
  }
}

// any d, w bf16 or fp32, rows aligned or not: a warp a row, the row read
// twice (the second time from L1 or L2); 16-byte vectors of x and y where
// aligned, else the scalar body
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
    rmsnorm_fwd_wide_kernel(const T* __restrict__ x,
                            const void* __restrict__ w, int w_bf16,
                            T* __restrict__ y, int n_rows, int d,
                            float inv_d, float eps, int aligned) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int lane = threadIdx.x % 32, nvec = d / N;
  const long long n_warps = (long long)gridDim.x * (FWD_THREADS / 32);
  release_next_grid();
  wait_prior_grid();
  for (long long row =
           (long long)blockIdx.x * (FWD_THREADS / 32) + threadIdx.x / 32;
       row < n_rows; row += n_warps) {
    const T* xr = x + row * d;
    T* yr = y + row * d;
    float ss = 0.f;
    if (aligned) {
      for (int v = lane; v < nvec; v += 32) {
        float f[N];
        V::unpack(reinterpret_cast<const uint4*>(xr)[v], f);
#pragma unroll
        for (int e = 0; e < N; ++e) ss = fmaf(f[e], f[e], ss);
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float f = to_f(xr[j]);
        ss = fmaf(f, f, ss);
      }
    }
    const float rstd = rsqrtf(group_sum<32>(ss) * inv_d + eps);
    if (aligned) {
      for (int v = lane; v < nvec; v += 32) {
        float f[N];
        V::unpack(reinterpret_cast<const uint4*>(xr)[v], f);
#pragma unroll
        for (int e = 0; e < N; ++e)
          f[e] = f[e] * rstd * w_at(w, w_bf16, v * N + e);
        reinterpret_cast<uint4*>(yr)[v] = V::pack(f);
      }
    } else {
      for (int j = lane; j < d; j += 32)
        yr[j] = of_f<T>(to_f(xr[j]) * rstd * w_at(w, w_bf16, j));
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// d <= 32 * E.  Warp k of CTA b takes row b * warps + k, then every
// (gridDim.x * warps)-th row after it, and CTA b writes row b of the
// (gridDim.x, d) fp32 partials.  Shared memory: w in fp32, then a ring of
// S = stages<T, E>() x (x row, dy row) per warp, which at the end holds the
// warps' dw.
// aligned: x, dy and dx 16-byte aligned and d a multiple of a vector; lane l
// owns the vectors l + 32 k (columns v N .. v N + N - 1).  Else the scalar
// body, lane l owning columns l + 32 k, read straight from device memory.
template <typename T, int E>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
                       int w_bf16, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ part,
                       int n_rows, int d, float eps, int aligned) {
  using V = Vec<T>;
  constexpr int N = V::N, NV = E / N, S = stages<T, E>();
  static_assert(E % N == 0, "E must fill whole vectors");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + w_bytes(d);
  wait_prior_grid();
  for (int j = threadIdx.x; j < d; j += blockDim.x) ws[j] = w_at(w, w_bf16, j);
  __syncthreads();

  const long long n_warps = (long long)gridDim.x * warps;
  const long long first = (long long)blockIdx.x * warps + warp;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  if (aligned) {
    const int nvec = d / N;
    // stage s of this warp: x at slot + 2 s d, dy right after it
    T* slot = reinterpret_cast<T*>(ring) + (size_t)warp * S * 2 * d;
    auto issue = [&](int s, long long row) {
      if (row >= n_rows) return;
      const T* xr = x + row * d;
      const T* gr = dy + row * d;
      T* sx = slot + (size_t)2 * s * d;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k;
        if (v < nvec) {
          cp_async16(sx + v * N, xr + v * N);
          cp_async16(sx + d + v * N, gr + v * N);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      issue(s, first + s * n_warps);
      cp_async_commit();
    }
    int stage = 0;
    for (long long row = first; row < n_rows; row += n_warps) {
      issue((stage + S - 1) % S, row + (S - 1) * n_warps);
      cp_async_commit();
      cp_async_wait<S - 1>();  // this row's copies have landed
      const T* sx = slot + (size_t)2 * stage * d;
      const T* sg = sx + d;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k;
        if (v < nvec) {
          float f[N], g[N];
          V::unpack(*reinterpret_cast<const uint4*>(sx + v * N), f);
          V::unpack(*reinterpret_cast<const uint4*>(sg + v * N), g);
          float wr[N];
          load_f32<N>(ws + v * N, wr);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            s1 = fmaf(f[e], f[e], s1);
            s2 = fmaf(f[e], wr[e] * g[e], s2);
          }
        }
      }
      const float rstd = rsqrtf(group_sum<32>(s1) / d + eps);
      const float c = rstd * (group_sum<32>(s2) / d);
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k;
        if (v < nvec) {
          float f[N], g[N], o[N];
          V::unpack(*reinterpret_cast<const uint4*>(sx + v * N), f);
          V::unpack(*reinterpret_cast<const uint4*>(sg + v * N), g);
          float wr[N];
          load_f32<N>(ws + v * N, wr);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float xh = f[e] * rstd;
            o[e] = (wr[e] * g[e] - xh * c) * rstd;
            acc[k * N + e] = fmaf(g[e], xh, acc[k * N + e]);
          }
          dxr[v] = V::pack(o);
        }
      }
      stage = (stage + 1) % S;
    }
    cp_async_wait<0>();
  } else {
    for (long long row = first; row < n_rows; row += n_warps) {
      const T* xr = x + row * d;
      const T* gr = dy + row * d;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int j = lane + 32 * k;
        if (j < d) {
          const float f = to_f(xr[j]), g = to_f(gr[j]);
          s1 = fmaf(f, f, s1);
          s2 = fmaf(f, ws[j] * g, s2);
        }
      }
      const float rstd = rsqrtf(group_sum<32>(s1) / d + eps);
      const float c = rstd * (group_sum<32>(s2) / d);
      T* dxr = dx + row * d;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int j = lane + 32 * k;
        if (j < d) {
          const float g = to_f(gr[j]), xh = to_f(xr[j]) * rstd;
          dxr[j] = of_f<T>((ws[j] * g - xh * c) * rstd);
          acc[k] = fmaf(g, xh, acc[k]);
        }
      }
    }
  }

  // the CTA's dw: each warp's in shared memory, then added in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring) + (size_t)warp * d;
  if (aligned) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < d / N) {
#pragma unroll
        for (int e = 0; e < N; ++e) red[v * N + e] = acc[k * N + e];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * k;
      if (j < d) red[j] = acc[k];
    }
  }
  __syncthreads();
  red = reinterpret_cast<float*>(ring);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < warps; ++k) t += red[(size_t)k * d + j];
    part[(size_t)blockIdx.x * d + j] = t;
  }
  release_next_grid();  // the column sum, which waits for all of this grid
}

// d > 32 * MAX_E, up to blockDim.x x NV x N: a row across the CTA.  CTA b
// takes rows b, b + gridDim.x, ... in turn and writes row b of the
// (gridDim.x, d) fp32 partials: its dw, summed over its rows in row order.
// Shared memory: w in fp32.
// aligned: thread t owns the vectors t + k blockDim.x (k < NV) of x, dy and
// dx, holds them in registers, and loads the next row's before it reduces
// the current one.  x and dy are loaded, and dx stored, with the streaming
// hint (.cs), which made the training shapes faster on the H100; the decode
// forward, whose rows the next kernel reads from L2, was slower with it, so
// the forward has none.  Else the scalar body, thread t owning columns t + k
// blockDim.x (k < NV N), read straight from device memory.
template <typename T, int NV>
__global__ void __launch_bounds__(CTA_MAX_THREADS)
    rmsnorm_bwd_cta_kernel(const T* __restrict__ x,
                           const void* __restrict__ w, int w_bf16,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, int n_rows, int d,
                           float eps, int aligned) {
  using V = Vec<T>;
  constexpr int N = V::N, E = NV * N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][2 * 32];
  float* ws = reinterpret_cast<float*>(smem);
  const int bd = blockDim.x;
  wait_prior_grid();
  for (int j = threadIdx.x; j < d; j += bd) ws[j] = w_at(w, w_bf16, j);
  __syncthreads();

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  int buf = 0;
  if (aligned) {
    const int nvec = d / N;
    uint4 xv[NV], gv[NV];
    const long long first = blockIdx.x;
    load_vecs<NV, true>(x + first * d, nvec, first < n_rows, xv);
    load_vecs<NV, true>(dy + first * d, nvec, first < n_rows, gv);
    for (long long row = first; row < n_rows; row += gridDim.x) {
      const long long next = row + gridDim.x;
      uint4 xn[NV], gn[NV];
      load_vecs<NV, true>(x + next * d, nvec, next < n_rows, xn);
      load_vecs<NV, true>(dy + next * d, nvec, next < n_rows, gn);
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = threadIdx.x + k * bd;
        if (v < nvec) {
          float f[N], g[N], wr[N];
          V::unpack(xv[k], f);
          V::unpack(gv[k], g);
          load_f32<N>(ws + v * N, wr);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            s[0] = fmaf(f[e], f[e], s[0]);
            s[1] = fmaf(f[e], wr[e] * g[e], s[1]);
          }
        }
      }
      cta_sum<2>(s, red[buf]);
      const float rstd = rsqrtf(s[0] / d + eps);
      const float c = rstd * (s[1] / d);
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = threadIdx.x + k * bd;
        if (v < nvec) {
          float f[N], g[N], wr[N], o[N];
          V::unpack(xv[k], f);
          V::unpack(gv[k], g);
          load_f32<N>(ws + v * N, wr);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float xh = f[e] * rstd;
            o[e] = (wr[e] * g[e] - xh * c) * rstd;
            acc[k * N + e] = fmaf(g[e], xh, acc[k * N + e]);
          }
          __stcs(dxr + v, V::pack(o));
        }
        xv[k] = xn[k];
        gv[k] = gn[k];
      }
      buf ^= 1;
    }
  } else {
    for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
      const T* xr = x + row * d;
      const T* gr = dy + row * d;
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int j = threadIdx.x + k * bd;
        if (j < d) {
          const float f = to_f(xr[j]), g = to_f(gr[j]);
          s[0] = fmaf(f, f, s[0]);
          s[1] = fmaf(f, ws[j] * g, s[1]);
        }
      }
      cta_sum<2>(s, red[buf]);
      const float rstd = rsqrtf(s[0] / d + eps);
      const float c = rstd * (s[1] / d);
      T* dxr = dx + row * d;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int j = threadIdx.x + k * bd;
        if (j < d) {
          const float g = to_f(gr[j]), xh = to_f(xr[j]) * rstd;
          dxr[j] = of_f<T>((ws[j] * g - xh * c) * rstd);
          acc[k] = fmaf(g, xh, acc[k]);
        }
      }
      buf ^= 1;
    }
  }

  // the CTA's partials row: each thread writes its own columns
  float* p = part + (size_t)blockIdx.x * d;
  if (aligned) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = threadIdx.x + k * bd;
      if (v < d / N) {
#pragma unroll
        for (int e = 0; e < N; e += 4)
          *reinterpret_cast<float4*>(p + v * N + e) =
              make_float4(acc[k * N + e], acc[k * N + e + 1],
                          acc[k * N + e + 2], acc[k * N + e + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = threadIdx.x + k * bd;
      if (j < d) p[j] = acc[k];
    }
  }
  release_next_grid();  // the column sum, which waits for all of this grid
}

// d past the cta body: CTAs of one warp, a row at a time, read twice; the
// CTA's dw is summed in place in its partials row (row blockIdx.x), in row
// order
template <typename T>
__global__ void __launch_bounds__(32)
    rmsnorm_bwd_wide_kernel(const T* __restrict__ x,
                            const void* __restrict__ w, int w_bf16,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, int n_rows, int d,
                            float eps, int aligned) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int lane = threadIdx.x, nvec = d / N;
  float* p = part + (size_t)blockIdx.x * d;
  wait_prior_grid();
  for (int j = lane; j < d; j += 32) p[j] = 0.f;
  __syncwarp();
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    T* dxr = dx + row * d;
    float s1 = 0.f, s2 = 0.f;
    if (aligned) {
      for (int v = lane; v < nvec; v += 32) {
        float f[N], g[N];
        V::unpack(reinterpret_cast<const uint4*>(xr)[v], f);
        V::unpack(reinterpret_cast<const uint4*>(gr)[v], g);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s1 = fmaf(f[e], f[e], s1);
          s2 = fmaf(f[e], w_at(w, w_bf16, v * N + e) * g[e], s2);
        }
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float f = to_f(xr[j]), g = to_f(gr[j]);
        s1 = fmaf(f, f, s1);
        s2 = fmaf(f, w_at(w, w_bf16, j) * g, s2);
      }
    }
    const float rstd = rsqrtf(group_sum<32>(s1) / d + eps);
    const float c = rstd * (group_sum<32>(s2) / d);
    if (aligned) {
      for (int v = lane; v < nvec; v += 32) {
        float f[N], g[N], o[N];
        V::unpack(reinterpret_cast<const uint4*>(xr)[v], f);
        V::unpack(reinterpret_cast<const uint4*>(gr)[v], g);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const int j = v * N + e;
          const float xh = f[e] * rstd;
          o[e] = (w_at(w, w_bf16, j) * g[e] - xh * c) * rstd;
          p[j] = fmaf(g[e], xh, p[j]);
        }
        reinterpret_cast<uint4*>(dxr)[v] = V::pack(o);
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float g = to_f(gr[j]), xh = to_f(xr[j]) * rstd;
        dxr[j] = of_f<T>((w_at(w, w_bf16, j) * g - xh * c) * rstd);
        p[j] = fmaf(g, xh, p[j]);
      }
    }
  }
  release_next_grid();
}

// dw[j] = sum over the partials rows p of part[p][j], in a fixed order:
// warp k of the CTA sums rows k, k + SUM_SPLIT, ... in turn, then the
// SUM_SPLIT sums meet in a tree (sum k += sum k + h for k < h, h =
// SUM_SPLIT / 2, ..., 1).  A CTA takes 32 columns.
__global__ void __launch_bounds__(SUM_SPLIT * 32)
    rmsnorm_bwd_dw_sum_kernel(const float* __restrict__ part,
                              void* __restrict__ dw, int w_bf16, int n_parts,
                              int d) {
  __shared__ float red[SUM_SPLIT][32];
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  release_next_grid();
  wait_prior_grid();
  float t = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int p = k; p < n_parts; p += SUM_SPLIT) t += part[(size_t)p * d + j];
  }
  red[k][lane] = t;
#pragma unroll
  for (int h = SUM_SPLIT / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (k < h) red[k][lane] += red[k + h][lane];
  }
  if (k == 0 && j < d) {
    if (w_bf16)
      static_cast<bf16*>(dw)[j] = __float2bfloat16(red[0][lane]);
    else
      static_cast<float*>(dw)[j] = red[0][lane];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// makes `device` current for the scope of a launch, and restores the
// caller's device after it
struct DeviceScope {
  int prev = -1;
  explicit DeviceScope(int device) {
    int cur = -1;
    if (cudaGetDevice(&cur) == cudaSuccess && cur != device &&
        cudaSetDevice(device) == cudaSuccess)
      prev = cur;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

int sm_count(int device) {
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    sms[device] = 132;
  return sms[device];
}

// launches kernel with programmatic dependent launch (see wait_prior_grid)
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int grid, int threads,
                   size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename T, int LANES, int E, int R>
cudaError_t fwd_warps(const void* x, const void* w, void* y, int n_rows,
                      int d, float eps, cudaStream_t s) {
  constexpr long long rows_per_cta = (FWD_THREADS / LANES) * R;
  return launch(rmsnorm_fwd_kernel<T, LANES, E, R>,
                (int)((n_rows + rows_per_cta - 1) / rows_per_cta),
                FWD_THREADS, 0, s, x, w, y, n_rows, d, 1.f / d, eps);
}

// a CTA a row, V vectors a thread: V 1 takes a thread a vector; V 2 at
// least 256 threads, or half the vectors
template <typename T, int V>
cudaError_t fwd_rows(const void* x, const void* w, void* y, int n_rows,
                     int d, float eps, cudaStream_t s) {
  const int nvec = d / Vec<T>::N;
  int threads = (nvec + 31) / 32 * 32;
  if (V == 2) {
    const int half = ((nvec + 1) / 2 + 31) / 32 * 32;
    threads = threads < 256 ? threads : (half > 256 ? half : 256);
  }
  return launch(rmsnorm_fwd_row_kernel<T, V>, n_rows, threads, 0, s, x, w, y,
                d, 1.f / d, eps);
}

// w in x's dtype, d <= 32 * MAX_E, x, w and y aligned.  d > 256: a CTA a
// row while the rows are few (up to 16 an SM), spread over more threads the
// fewer they are.  Else the warp body: the fewest elements a lane that hold
// the row, and rows a group that keep a few KB a warp in flight (at d <=
// 128, more rows a group once the rows are many).  The thresholds are from
// timings on the H100 at the serving and training shapes.
template <typename T>
cudaError_t fwd_dispatch(const void* x, const void* w, void* y, int n_rows,
                         int d, float eps, int sms, cudaStream_t s) {
  if (d > 256 && n_rows <= 4 * sms)
    return fwd_rows<T, 1>(x, w, y, n_rows, d, eps, s);
  if (d > 256 && n_rows <= 16 * sms)
    return fwd_rows<T, 2>(x, w, y, n_rows, d, eps, s);
  if (d <= 128)
    return n_rows < 65536
               ? fwd_warps<T, 16, 8, 2>(x, w, y, n_rows, d, eps, s)
               : fwd_warps<T, 16, 8, 4>(x, w, y, n_rows, d, eps, s);
  if (d <= 256)
    return fwd_warps<T, 32, 8, 4>(x, w, y, n_rows, d, eps, s);
  if (d <= 512)
    return fwd_warps<T, 32, 16, 2>(x, w, y, n_rows, d, eps, s);
  if (d <= 1024)
    return fwd_warps<T, 32, 32, 1>(x, w, y, n_rows, d, eps, s);
  if (d <= 2048)
    return fwd_warps<T, 32, 64, 1>(x, w, y, n_rows, d, eps, s);
  return fwd_warps<T, 32, MAX_E, 1>(x, w, y, n_rows, d, eps, s);
}

// CTAs an SM of the forward's cta body at `threads` threads (occupancy
// API), kept by device and threads: the decode step calls the forward
// 2L + 1 times
template <typename T>
int fwd_cta_per_sm(int device, int threads) {
  static int known[64][CTA_MAX_THREADS / 32 + 1];
  int* k = device >= 0 && device < 64 ? &known[device][threads / 32]
                                       : nullptr;
  if (k && *k > 0) return *k;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rmsnorm_fwd_cta_kernel<T, CTA_NV>, threads, 0) != cudaSuccess ||
      n < 1)
    n = 1;
  if (k) *k = n;
  return n;
}

// w in x's dtype, cta_takes<T>(d), x, w and y aligned: the persistent cta
// body, a CTA a row at once, as many CTAs as the rows or as the card holds
// (at few rows it was also faster than the row kernel on the H100)
template <typename T>
cudaError_t fwd_cta(const void* x, const void* w, void* y, int n_rows, int d,
                    float eps, int device, int sms, cudaStream_t s) {
  const int threads = cta_threads<T>(d);
  const long long cap = (long long)fwd_cta_per_sm<T>(device, threads) * sms;
  return launch(rmsnorm_fwd_cta_kernel<T, CTA_NV>,
                (int)(n_rows < cap ? n_rows : cap), threads, 0, s, x, w, y,
                n_rows, d, 1.f / d, eps);
}

template <typename T>
cudaError_t fwd_wide(const void* x, const void* w, int w_bf16, void* y,
                     int n_rows, int d, float eps, int aligned,
                     cudaStream_t s) {
  constexpr long long rows_per_cta = FWD_THREADS / 32;
  return launch(rmsnorm_fwd_wide_kernel<T>,
                (int)((n_rows + rows_per_cta - 1) / rows_per_cta),
                FWD_THREADS, 0, s, x, w, w_bf16, y, n_rows, d, 1.f / d, eps,
                aligned);
}

// the backward kernels of one dtype share a signature
template <typename T>
using BwdKernel = void (*)(const T*, const void*, int, const T*, T*, float*,
                           int, int, float, int);

// the backward kernel for (d, T), its threads a CTA, the rows a CTA takes
// at once (its warps in the register body, one row in the cta and looped
// bodies) and its dynamic shared memory
template <typename T>
struct BwdPlan {
  BwdKernel<T> kernel;
  int threads;
  int rows;
  size_t smem;
};

// as many warps as the ring of stages<T, E>() rows fits in shared memory,
// at most BWD_MAX_WARPS
template <typename T, int E>
BwdPlan<T> bwd_plan_e(int d) {
  const size_t ring = (size_t)stages<T, E>() * 2 * d * sizeof(T);
  size_t warps = (SMEM_CAP - w_bytes(d)) / ring;
  if (warps > BWD_MAX_WARPS) warps = BWD_MAX_WARPS;
  return {rmsnorm_bwd_kernel<T, E>, (int)warps * 32, (int)warps,
          w_bytes(d) + warps * ring};
}

template <typename T>
BwdPlan<T> bwd_plan(int d) {
  if (cta_takes<T>(d))
    return {rmsnorm_bwd_cta_kernel<T, CTA_NV>, cta_threads<T>(d), 1,
            w_bytes(d)};
  if (d > 32 * MAX_E) return {rmsnorm_bwd_wide_kernel<T>, 32, 1, 0};
  return d <= 256    ? bwd_plan_e<T, 8>(d)
         : d <= 512  ? bwd_plan_e<T, 16>(d)
         : d <= 1024 ? bwd_plan_e<T, 32>(d)
         : d <= 2048 ? bwd_plan_e<T, 64>(d)
                     : bwd_plan_e<T, MAX_E>(d);
}

// past 48 KB a CTA's shared memory must be allowed; the cta body has 512
// bytes of static shared memory beside p.smem
template <typename T>
cudaError_t allow_smem(const BwdPlan<T>& p) {
  if (p.smem <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(p.kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.smem);
}

// out[0] rows a CTA takes at once, out[1] CTAs an SM, out[3] threads a CTA
template <typename T>
cudaError_t bwd_config(int d, int* out) {
  const BwdPlan<T> p = bwd_plan<T>(d);
  out[0] = p.rows;
  out[3] = p.threads;
  cudaError_t err = allow_smem(p);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, p.kernel,
                                                        p.threads, p.smem);
  return err;
}

template <typename T>
cudaError_t bwd_launch(const void* x, const void* w, int w_bf16,
                       const void* dy, void* dx, float* part, void* dw,
                       int n_rows, int d, float eps, int n_ctas,
                       cudaStream_t s) {
  const BwdPlan<T> p = bwd_plan<T>(d);
  const int aligned = d % Vec<T>::N == 0 && aligned16(x) && aligned16(dy) &&
                      aligned16(dx);
  cudaError_t err = allow_smem(p);
  if (err == cudaSuccess)
    err = launch(p.kernel, n_ctas, p.threads, p.smem, s, x, w, w_bf16, dy,
                 dx, part, n_rows, d, eps, aligned);
  if (err == cudaSuccess)
    err = launch(rmsnorm_bwd_dw_sum_kernel, (d + 31) / 32, SUM_SPLIT * 32, 0,
                 s, part, dw, w_bf16, n_ctas, d);
  return err;
}

bool dtypes_ok(int x_dtype, int w_dtype) {
  return (x_dtype == 0 || x_dtype == 1) && (w_dtype == 0 || w_dtype == 1);
}

}  // namespace

// y = rmsnorm(x, w) over (n_rows, d) contiguous rows.  dtype codes: 0
// float32, 1 bfloat16.  Launches on `stream` of `device`; returns the CUDA
// error of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int n_rows,
                           int d, int x_dtype, int w_dtype, float eps,
                           int device, void* stream) {
  if (n_rows < 0 || d <= 0 || !dtypes_ok(x_dtype, w_dtype))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = x_dtype ? 8 : 4;
  const int aligned = d % vec == 0 && aligned16(x) && aligned16(y);
  if (x_dtype == w_dtype && aligned && aligned16(w)) {
    const int sms = sm_count(device);
    if (d <= 32 * MAX_E)
      return (int)(x_dtype
                       ? fwd_dispatch<bf16>(x, w, y, n_rows, d, eps, sms, s)
                       : fwd_dispatch<float>(x, w, y, n_rows, d, eps, sms,
                                             s));
    if (x_dtype ? cta_takes<bf16>(d) : cta_takes<float>(d))
      return (int)(x_dtype ? fwd_cta<bf16>(x, w, y, n_rows, d, eps, device,
                                           sms, s)
                           : fwd_cta<float>(x, w, y, n_rows, d, eps, device,
                                            sms, s));
  }
  return (int)(x_dtype ? fwd_wide<bf16>(x, w, w_dtype, y, n_rows, d, eps,
                                        aligned, s)
                       : fwd_wide<float>(x, w, w_dtype, y, n_rows, d, eps,
                                         aligned, s));
}

// The forward's geometry past d 2560 for (d, x_dtype) on `device`, for
// aligned rows with w in x's dtype: out[0] threads a CTA of the cta body,
// out[1] its CTAs an SM (occupancy API); both 0 where the cta body does not
// take d (d <= 2560 or past CTA_MAX_THREADS threads).
extern "C" int rmsnorm_fwd_config(int d, int x_dtype, int device, int* out) {
  if (d <= 0 || !dtypes_ok(x_dtype, 0)) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  out[0] = out[1] = 0;
  if (!(x_dtype ? cta_takes<bf16>(d) : cta_takes<float>(d))) return 0;
  const int threads = x_dtype ? cta_threads<bf16>(d) : cta_threads<float>(d);
  out[0] = threads;
  out[1] = x_dtype ? fwd_cta_per_sm<bf16>(device, threads)
                   : fwd_cta_per_sm<float>(device, threads);
  return 0;
}

// The backward's geometry for (d, x_dtype) on `device`: out[0] rows a CTA
// takes at once, out[1] CTAs an SM (occupancy API), out[2] SMs, out[3]
// threads a CTA.  The caller sizes the persistent grid and the (CTAs, d)
// fp32 partials buffer from out[0..2].
extern "C" int rmsnorm_bwd_config(int d, int x_dtype, int device, int* out) {
  if (d <= 0 || !dtypes_ok(x_dtype, 0)) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  out[2] = sm_count(device);
  return (int)(x_dtype ? bwd_config<bf16>(d, out) : bwd_config<float>(d, out));
}

// dx, dw of sum(rmsnorm(x, w) * dy) over (n_rows, d) contiguous rows, on a
// grid of n_ctas CTAs (n_rows >= 1).  part: (n_ctas, d) fp32 scratch.
// Two launches: the rows, then the column sums of the partials into dw.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* part, void* dw, int n_rows, int d,
                           int x_dtype, int w_dtype, float eps, int n_ctas,
                           int device, void* stream) {
  if (n_rows <= 0 || d <= 0 || n_ctas <= 0 || !dtypes_ok(x_dtype, w_dtype))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  return (int)(x_dtype ? bwd_launch<bf16>(x, w, w_dtype, dy, dx, p, dw,
                                          n_rows, d, eps, n_ctas, s)
                       : bwd_launch<float>(x, w, w_dtype, dy, dx, p, dw,
                                           n_rows, d, eps, n_ctas, s));
}
