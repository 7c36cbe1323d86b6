// Grouped (expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (moe_gmm /
// _gmm_kernel). Same contract: lhs (T, D) rows sorted by expert in runs of
// whole row tiles of block_t rows (T % block_t == 0), rhs (E, D, F),
// tile_expert (T / block_t,) int32; out (T, F) is row tile i times
// rhs[tile_expert[i]], accumulated in fp32 and stored in lhs's dtype. All
// row-major and contiguous, lhs/rhs/out in one dtype (fp32 or bf16). Expert
// ids are clamped to [0, E-1] (the TPU index map would read out of bounds).
//
// Bound on the H100: on the serving path the expert weights dominate. At the
// decode wave (mixtral at full width, 4 slots: lhs (64, 6144), rhs
// (8, 6144, 16384) bf16) a call must read 1.61 GB of rhs, 0.48 ms at
// 3.35 TB/s, against 0.013 ms of bf16 tensor-core work: bound by bytes. At a
// 512-token prefill (lhs (1280, 6144)) it is 1.67 GB (0.50 ms) against
// 258 GFLOP (0.26 ms at 989 TFLOP/s): bytes again, by less.
//
// Design (simple and right; not fast): the TPU kernel hoists row -> expert
// into a scalar-prefetched index map; here each CTA reads its own
// tile_expert entries. A CTA owns a BM x 256 output tile, BM the largest of
// 64/32/16/8 that divides block_t, so on the serving path a CTA never
// straddles two experts. (When block_t is not a multiple of 8, BM is 8 and
// the CTA walks the runs of equal expert among its rows, one pass over D per
// run with the other rows' lhs staged as zeros, so any block_t is right.)
// The CTA walks D in chunks of 16, staging lhs (transposed) and rhs chunks
// in shared memory as fp32 from 16-byte loads, double-buffered, with the
// next chunk's loads in registers while the current one is multiplied. Each
// thread keeps an 8 x (BM/8) fp32 accumulator tile in registers, its 8 rows
// read as float4 broadcasts and its columns interleaved so that a warp reads
// 32 neighbouring words of the rhs chunk. The F, D and T edges are masked
// here (no padding copy of rhs). Products are fp32 FMAs on the CUDA cores;
// mma.sync/wgmma and TMA are for a later PR.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;   // depth of a staged chunk
constexpr int kBN = 256;  // output columns of a CTA
constexpr int kTM = 8;    // output rows of a thread

template <typename T>
struct alignas(16) Chunk {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ int clamp_expert(int e, int n_experts) {
  return min(max(e, 0), n_experts - 1);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ tile_expert, T* __restrict__ out,
               int t_rows, int d, int f, int n_experts, int block_t,
               int lhs_vec, int rhs_vec) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int TR = BM / kTM;        // thread rows
  constexpr int TC = kThreads / TR;   // thread columns (>= 32: a warp shares its rows)
  constexpr int TN = kBN / TC;        // output columns of a thread
  constexpr int A_TOTAL = BM * kBK / VEC, B_TOTAL = kBK * kBN / VEC;
  constexpr int A_CHUNKS = (A_TOTAL + kThreads - 1) / kThreads;
  constexpr int B_CHUNKS = (B_TOTAL + kThreads - 1) / kThreads;
  static_assert(BM % kTM == 0 && TC >= 32 && TC * TN == kBN, "tile shape");

  __shared__ __align__(16) float a_s[2][kBK][BM];
  __shared__ __align__(16) float b_s[2][kBK][kBN];

  const int tid = threadIdx.x, ty = tid / TC, tx = tid % TC;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int row_end = min(m0 + BM, t_rows);
  const T zero = from_f32<T>(0.f);

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Chunk<T> a_r[A_CHUNKS], b_r[B_CHUNKS];

  // lhs rows [r_lo, r_hi) and rhs_e rows [k0, k0 + kBK) into registers
  auto load = [&](const T* rhs_e, int k0, int r_lo, int r_hi) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      if (c >= A_TOTAL) break;
      const int row = m0 + c / (kBK / VEC), k = k0 + (c % (kBK / VEC)) * VEC;
      const bool row_in = row >= r_lo && row < r_hi;
      const T* p = lhs + static_cast<size_t>(row) * d + k;
      if (row_in && lhs_vec && k + VEC <= d) {
        a_r[i] = *reinterpret_cast<const Chunk<T>*>(p);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) a_r[i].v[v] = (row_in && k + v < d) ? p[v] : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      if (c >= B_TOTAL) break;
      const int k = k0 + c / (kBN / VEC), col = n0 + (c % (kBN / VEC)) * VEC;
      const T* p = rhs_e + static_cast<size_t>(k) * f + col;
      if (k < d && rhs_vec && col + VEC <= f) {
        b_r[i] = *reinterpret_cast<const Chunk<T>*>(p);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) b_r[i].v[v] = (k < d && col + v < f) ? p[v] : zero;
      }
    }
  };

  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      if (c >= A_TOTAL) break;
      const int r = c / (kBK / VEC), k = (c % (kBK / VEC)) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) a_s[buf][k + v][r] = to_f32(a_r[i].v[v]);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      if (c >= B_TOTAL) break;
      const int k = c / (kBN / VEC), col = (c % (kBN / VEC)) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; v += 4) {
        *reinterpret_cast<float4*>(&b_s[buf][k][col + v]) = make_float4(
            to_f32(b_r[i].v[v]), to_f32(b_r[i].v[v + 1]), to_f32(b_r[i].v[v + 2]),
            to_f32(b_r[i].v[v + 3]));
      }
    }
  };

  // The iteration count runs on across runs, so the buffer a thread fills
  // is never the one a slower thread may still be reading.
  int it = 0;
  for (int r_lo = m0; r_lo < row_end;) {
    const int tile = r_lo / block_t;
    const int e = clamp_expert(tile_expert[tile], n_experts);
    int r_hi = (tile + 1) * block_t;
    while (r_hi < row_end && clamp_expert(tile_expert[r_hi / block_t], n_experts) == e)
      r_hi += block_t;
    r_hi = min(r_hi, row_end);
    const T* rhs_e = rhs + static_cast<size_t>(e) * d * f;

    load(rhs_e, 0, r_lo, r_hi);
    for (int k0 = 0; k0 < d; k0 += kBK, ++it) {
      const int buf = it & 1;
      stage(buf);
      __syncthreads();
      if (k0 + kBK < d) load(rhs_e, k0 + kBK, r_lo, r_hi);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kTM], b[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * kTM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * kTM + 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = b_s[buf][kk][tx + TC * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    r_lo = r_hi;
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty * kTM + i;
    if (row >= row_end) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + TC * j;
      if (col < f) out[static_cast<size_t>(row) * f + col] = from_f32<T>(acc[i][j]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int BM>
void launch(const void* lhs, const void* rhs, const int* te, void* out, int t, int d,
            int f, int e, int block_t, cudaStream_t s) {
  constexpr int VEC = Chunk<T>::N;
  const dim3 grid((t + BM - 1) / BM, (f + kBN - 1) / kBN);
  const int lhs_vec = aligned16(lhs) && d % VEC == 0;
  const int rhs_vec = aligned16(rhs) && f % VEC == 0;
  moe_gmm_kernel<T, BM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), te, static_cast<T*>(out),
      t, d, f, e, block_t, lhs_vec, rhs_vec);
}

template <typename T>
void dispatch(const void* lhs, const void* rhs, const int* te, void* out, int t, int d,
              int f, int e, int block_t, cudaStream_t s) {
  if (block_t % 64 == 0) launch<T, 64>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else if (block_t % 32 == 0) launch<T, 32>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else if (block_t % 16 == 0) launch<T, 16>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else launch<T, 8>(lhs, rhs, te, out, t, d, f, e, block_t, s);
}

}  // namespace

// lhs (t, d), rhs (e, d, f), out (t, f) contiguous in `dtype`; tile_expert
// (t / block_t,) int32; t % block_t == 0. Returns cudaGetLastError().
extern "C" int moe_gmm_launch(const void* lhs, const void* rhs, const void* tile_expert,
                              void* out, int t, int d, int f, int e, int block_t,
                              int dtype, void* stream) {
  if (block_t <= 0 || e <= 0 || t % block_t != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  if (dtype == kF32) dispatch<float>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else if (dtype == kBF16) dispatch<__nv_bfloat16>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
