// RMSNorm over the rows of a (rows, D) matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm /
// _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * w, in fp32, stored in
// x's dtype. Bound on the H100 by bytes: it reads x once and writes y once
// (2 * rows * D * sizeof(x) over 3.35 TB/s); at the decode shape (4 x 2048
// bf16) it is bound by the launch. Design: one block of 256 threads per row,
// no padding of the row count. Each thread reads 16-byte vectors (8 bf16 or
// 4 fp32), squares and sums in fp32, the block reduces with warp shuffles
// plus a word of shared memory per warp, and the second pass re-reads the
// row, which a 4 KB row finds in L1/L2 rather than in device memory.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < d; i += kThreads * VEC) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = to_f32(p.v[j]);
      ss += f * f;
    }
  }

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int i = threadIdx.x * VEC; i < d; i += kThreads * VEC) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>((to_f32(p.v[j]) * r) * w[i + j]);
    *reinterpret_cast<Pack<T, VEC>*>(yr + i) = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* w, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  rmsnorm_kernel<T, VEC><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), d, eps);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x, y: (rows, d) contiguous in `dtype`; w: (d,) fp32. Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int d,
                              float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(y);
  if (dtype == kF32) {
    if (vec_ok && d % 4 == 0) launch<float, 4>(x, w, y, rows, d, eps, s);
    else launch<float, 1>(x, w, y, rows, d, eps, s);
  } else if (dtype == kBF16) {
    if (vec_ok && d % 8 == 0) launch<__nv_bfloat16, 8>(x, w, y, rows, d, eps, s);
    else launch<__nv_bfloat16, 1>(x, w, y, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
