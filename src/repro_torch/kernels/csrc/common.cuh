// Shared helpers for the port's kernels: dtype codes, fp32 conversion,
// 16-byte staging and the bf16 tensor-core fragments.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Dtype codes passed from Python (kernels/build.py DTYPE_CODES).
enum DtypeCode : int { kF32 = 0, kBF16 = 1 };

constexpr float kLog2e = 1.4426950408889634f;

// The address is a multiple of 16 bytes (host side: picks the 16-byte paths).
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16-byte asynchronous copy from device memory into shared memory (sm_80+).
// With `src_bytes` < 16 the rest of the 16 bytes is zero-filled; with 0
// nothing is read (the source must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- bf16 tensor-core tiles (mma.sync.m16n8k16, sm_80+) --------------------
// Fragments of one warp, with g = lane / 4 and c = lane % 4: an A tile (16 x
// 16, row-major) is four registers of two bf16 each, a0 (row g, cols 2c, 2c+1),
// a1 (row g + 8), a2 (row g, cols 8 + 2c), a3 (row g + 8, cols 8 + 2c); a B
// tile (16 x 8) is b0 (rows 2c, 2c+1 of col g) and b1 (rows 8 + 2c); the fp32
// accumulator (16 x 8) is c0, c1 (row g, cols 2c, 2c+1) and c2, c3 (row g + 8).

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives matrix i (thread t: row
// t / 4, cols 2 (t % 4) and + 1; with .trans, col t / 4 of rows 2 (t % 4), + 1).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, `lo` in the low
// half: the element with the lower column index of an A fragment.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// An fp32 value as hi + lo, both bf16: hi the value rounded to bf16, lo the
// rest rounded to bf16, so hi + lo is within 2^-16 of the value (relative).
// Two products hi * b + lo * b against an exact bf16 b then keep the fp32
// operand's precision on the tensor cores.
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// Rows [r0, r0 + n_rows) of a (seq, w) bf16 operand at `base` (seq stride
// `ss`, unit column stride) into a shared tile of row stride RS, columns
// [0, w); rows at or past `rows_end` are zero-filled. THREADS threads of the
// block share the copy. With `vec` (w a multiple of 8, base and stride
// 16-byte aligned) by 16-byte cp.async, which the caller commits and waits
// for; else by scalar loads and stores.
template <int RS, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long ss, int r0, int rows_end, int w, bool vec,
                                           int n_rows) {
  if (vec) {
    const int ch = w / 8;
    for (int i = threadIdx.x; i < n_rows * ch; i += THREADS) {
      const int r = i / ch, c = (i % ch) * 8;
      const bool in = r0 + r < rows_end;
      cp_async16(dst + r * RS + c, in ? base + static_cast<long long>(r0 + r) * ss + c : base,
                 in ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < n_rows * w; i += THREADS) {
      const int r = i / w, c = i % w;
      dst[r * RS + c] = r0 + r < rows_end ? base[static_cast<long long>(r0 + r) * ss + c] : zero;
    }
  }
}

// Lets `kernel` use `bytes` of dynamic shared memory on the current device:
// cudaFuncSetAttribute on the first call for each device, then nothing, so
// a launch pays no attribute call. `done` is the kernel's own flags.
constexpr int kMaxDevices = 16;
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}
