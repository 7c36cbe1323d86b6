// RMSNorm over the rows of a (rows, D) matrix, with the residual add and the
// Mamba2 gate fused in front of it, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm /
// _rmsnorm_kernel): y = (x * rsqrt(mean(x^2) + eps)) * w in fp32, rounded
// once to x's dtype. Two prologues fold in the compositions the models put
// around it (repro/models/layers.py, rms_norm after a residual add and
// gated_rms_norm):
//   plain     y = rmsnorm(x)
//   residual  s = x + h, rounded to the dtype as torch.add rounds it (fp32
//             sum, nearest even) and stored; y = rmsnorm(s)
//   gated     y = rmsnorm(x * silu(z)), silu(z) and the product each rounded
//             to the dtype, as `x * F.silu(z)` rounds them
// and the gated norm split in two passes, for a row whose channels lie on
// several ranks (Mamba2's d_inner under tensor parallelism): the caller
// sums pass A's output over the ranks and hands the sum to pass B.
//   gated_ssq    ssq[row] = sum((x * silu(z))^2) in fp32, the product
//                rounded as the gated form rounds it
//   gated_scale  y = (x * silu(z)) * rsqrt(ssq[row] / dn + eps) * w, dn the
//                row's width over every rank
// x, h and z are read through a row stride (z is a column slice of Mamba2's
// in_proj output); s and y are written contiguous.
//
// Bound on the H100 by bytes: each input read once, each output written
// once, over 3.35 TB/s (the flops are a few per element on fp32 cores). At
// the decode wave (4-8 rows, 16-40 KB) the launch sets the time; the fused
// forms take the add, and silu and mul, out of the launches around it.
//
// Design. One CTA owns one row and keeps it in registers: thread t holds the
// 16-byte vectors t, t + blockDim.x, ... (NV of them, the fewest of 1, 2, 4,
// 8 that cover the row: no slot is computed that holds nothing), so x, h or z
// and w are read once, all loads issued before the reduction, and there is no
// second pass over the row. The launch gives each thread one vector where 8
// warps allow it (at the configs' widths a 256-thread CTA; on the H100 the
// fastest of the shapes measured from 4 to 512 rows, PERF.md), and the warps
// combine their shuffle sums through shared memory after one barrier. Every
// form runs the same reduction in the same order for the same D, so the
// residual form's y is the plain form's y on its s, bit for bit. A base, row
// stride or D that does not allow 16-byte vectors takes the element-wise
// path, which keeps the same ownership of elements and so the same order of
// sums. The two passes keep the gated form's ownership and order: on one
// rank (dn = d) pass A's sum is the gated form's, and pass B's y is its y,
// bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

enum Form : int { kPlain = 0, kResidual = 1, kGated = 2, kGatedSsq = 3, kGatedScale = 4 };

constexpr int kMaxThreads = 256;
// the most 16-byte vectors a thread holds: D <= kMaxThreads * kMaxNV * (16 /
// sizeof(T)), 16384 in bf16 and 8192 in fp32
constexpr int kMaxNV = 8;

template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
  T v[N];
};

struct Args {
  const void* x;   // (rows, d), row stride sx
  const void* hz;  // residual: h, gated: z; (rows, d), row stride sh
  const float* w;  // (d,)
  void* y;         // (rows, d) contiguous; gated_ssq: ssq (rows,) fp32
  void* s;         // residual: (rows, d) contiguous; gated_scale: ssq (rows,) fp32
  long long sx, sh;
  int rows, d;
  int dn;          // the width the mean divides by: d, or the row's over every rank
  float eps;
};

// Vector k of a row: one 16-byte load, or element by element with the
// elements past D read as 0.
template <typename T, bool V16>
__device__ __forceinline__ void load(Pack<T>& p, const T* row, int k, int d) {
  constexpr int N = Pack<T>::N;
  if constexpr (V16) {
    p = *reinterpret_cast<const Pack<T>*>(row + static_cast<long long>(k) * N);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int i = k * N + e;
      p.v[e] = i < d ? row[i] : from_f32<T>(0.f);
    }
  }
}

template <typename T, bool V16>
__device__ __forceinline__ void store(T* row, int k, int d, const Pack<T>& p) {
  constexpr int N = Pack<T>::N;
  if constexpr (V16) {
    *reinterpret_cast<Pack<T>*>(row + static_cast<long long>(k) * N) = p;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int i = k * N + e;
      if (i < d) row[i] = p.v[e];
    }
  }
}

template <int N, bool V16>
__device__ __forceinline__ void load_w(float (&wv)[N], const float* w, int k, int d) {
  if constexpr (V16) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(w + k * N)[q];
      wv[4 * q] = f.x;
      wv[4 * q + 1] = f.y;
      wv[4 * q + 2] = f.z;
      wv[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) wv[e] = k * N + e < d ? w[k * N + e] : 0.f;
  }
}

// silu in fp32, z / (1 + exp(-z)) as torch computes it, with the fast exp and
// divide (within a few fp32 ulps of expf and IEEE division; no branches, so
// the elements of a thread interleave)
__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

template <typename T, int FORM, bool V16, int NV>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(Args a) {
  constexpr int N = Pack<T>::N;
  const int tpr = blockDim.x, t = threadIdx.x, row = blockIdx.x;
  const int nvec = (a.d + N - 1) / N;
  const T* xr = static_cast<const T*>(a.x) + static_cast<long long>(row) * a.sx;
  const T* hr = static_cast<const T*>(a.hz) + static_cast<long long>(row) * a.sh;

  // every load of the row first: x, h or z, w
  Pack<T> p[NV], q[FORM == kPlain ? 1 : NV];
  float wv[NV][N];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * tpr;
    if (k < nvec) {
      load<T, V16>(p[j], xr, k, a.d);
      if constexpr (FORM != kPlain) load<T, V16>(q[j], hr, k, a.d);
      if constexpr (FORM != kGatedSsq) load_w<N, V16>(wv[j], a.w, k, a.d);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        p[j].v[e] = from_f32<T>(0.f);
        if constexpr (FORM != kPlain) q[j].v[e] = from_f32<T>(0.f);
        wv[j][e] = 0.f;
      }
    }
  }

  // the prologue: the values the norm reads, each rounded to T
  if constexpr (FORM != kPlain) {
    T* sr = FORM == kResidual ? static_cast<T*>(a.s) + static_cast<long long>(row) * a.d
                              : nullptr;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xf = to_f32(p[j].v[e]), qf = to_f32(q[j].v[e]);
        if constexpr (FORM == kResidual) p[j].v[e] = from_f32<T>(xf + qf);
        else p[j].v[e] = from_f32<T>(xf * to_f32(from_f32<T>(silu(qf))));
      }
      const int k = t + j * tpr;
      if constexpr (FORM == kResidual) {
        if (k < nvec) store<T, V16>(sr, k, a.d, p[j]);
      }
    }
  }

  // sum of squares: the thread's vectors in order, then the warp's butterfly
  // (every lane ends with the same sum), then the CTA's warps in order;
  // gated_scale reads the sum over every rank instead
  float ss = 0.f;
  if constexpr (FORM == kGatedScale) {
    ss = static_cast<const float*>(a.s)[row];
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = to_f32(p[j].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
    ss = warp_sum(ss);
    if (tpr > 32) {  // uniform over the CTA: every thread reaches the barrier
      __shared__ float part[kMaxThreads / 32];
      if ((t & 31) == 0) part[t >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < tpr / 32; ++i) ss += part[i];
    }
  }
  if constexpr (FORM == kGatedSsq) {
    if (t == 0) static_cast<float*>(a.y)[row] = ss;
    return;
  }
  const float r = rsqrtf(ss / static_cast<float>(a.dn) + a.eps);

  T* yr = static_cast<T*>(a.y) + static_cast<long long>(row) * a.d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * tpr;
    if (k < nvec) {
      Pack<T> o;
#pragma unroll
      for (int e = 0; e < N; ++e) o.v[e] = from_f32<T>((to_f32(p[j].v[e]) * r) * wv[j][e]);
      store<T, V16>(yr, k, a.d, o);
    }
  }
}

template <typename T, int FORM, int NV>
cudaError_t launch(const Args& a, bool v16, int threads, cudaStream_t stream) {
  if (v16) rmsnorm_kernel<T, FORM, true, NV><<<a.rows, threads, 0, stream>>>(a);
  else rmsnorm_kernel<T, FORM, false, NV><<<a.rows, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int FORM>
cudaError_t launch_nv(const Args& a, int nv, bool v16, int threads, cudaStream_t s) {
  if (nv == 1) return launch<T, FORM, 1>(a, v16, threads, s);
  if (nv == 2) return launch<T, FORM, 2>(a, v16, threads, s);
  if (nv == 4) return launch<T, FORM, 4>(a, v16, threads, s);
  return launch<T, FORM, kMaxNV>(a, v16, threads, s);
}

template <typename T>
cudaError_t launch_form(const Args& a, int form, int nv, bool v16, int threads,
                        cudaStream_t s) {
  if (form == kPlain) return launch_nv<T, kPlain>(a, nv, v16, threads, s);
  if (form == kResidual) return launch_nv<T, kResidual>(a, nv, v16, threads, s);
  if (form == kGated) return launch_nv<T, kGated>(a, nv, v16, threads, s);
  if (form == kGatedSsq) return launch_nv<T, kGatedSsq>(a, nv, v16, threads, s);
  return launch_nv<T, kGatedScale>(a, nv, v16, threads, s);
}

}  // namespace

// x: (rows, d) at row stride sx; hz: h (residual) or z (the gated forms)
// at row stride sh, unused by the plain form; w: (d,) fp32, unused by
// gated_ssq; y: (rows, d) contiguous, or gated_ssq's fp32 sums (rows,); s:
// the residual form's (rows, d) contiguous sum, or gated_scale's fp32 sums
// (rows,) over every rank; x, hz, y (but gated_ssq's) and s (residual) in
// `dtype`; dn: the width the mean divides by (d but for gated_scale). One
// CTA a row, of the fewest warps (at most 8) that give each thread one
// 16-byte vector; d must fit kMaxThreads * kMaxNV vectors. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int rmsnorm_launch(const void* x, const void* hz, const void* w, void* y, void* s,
                              long long sx, long long sh, int rows, int d, int dn, float eps,
                              int form, int dtype, void* stream) {
  const int n = dtype == kF32 ? 4 : 8;  // elements a 16-byte vector
  const int nvec = (d + n - 1) / n;
  if (d <= 0 || dn <= 0 || nvec > kMaxThreads * kMaxNV || form < kPlain ||
      form > kGatedScale || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const bool two = form != kPlain;
  const bool v16 = d % n == 0 && sx % n == 0 && (!two || sh % n == 0) && aligned16(x) &&
                   (form == kGatedSsq || (aligned16(w) && aligned16(y))) &&
                   (!two || aligned16(hz)) && (form != kResidual || aligned16(s));
  const int warps = (nvec + 31) / 32;
  const int threads = warps < kMaxThreads / 32 ? 32 * warps : kMaxThreads;
  // vectors a thread holds: the fewest of 1, 2, 4, 8 that cover the row
  const int need = (nvec + threads - 1) / threads;
  const int nv = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : kMaxNV;
  const Args a{x, hz, static_cast<const float*>(w), y, s, sx, sh, rows, d, dn, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == kF32 ? launch_form<float>(a, form, nv, v16, threads, st)
                                        : launch_form<__nv_bfloat16>(a, form, nv, v16, threads, st);
  return static_cast<int>(err);
}
