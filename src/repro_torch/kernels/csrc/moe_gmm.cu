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
// 258 GFLOP (0.26 ms at 989 TFLOP/s): bytes again, by less, so the products
// must run on the tensor cores and each rhs byte must leave HBM about once.
//
// Design, bf16: products on the tensor cores with fp32 accumulators. The
// wrapper picks one of two row tiles from T and E:
// - wide (gmm_wgmma_kernel; prefill, T >= 32 E): at a long admission
//   (deepseek at s = 4096: t 32,768 launched rows, D and F 1408-2048) a
//   call is bound by operations, not bytes, so the tensor cores must not
//   wait. A persistent kernel, one CTA an SM, whose CTAs walk output tiles
//   of 128 rows x 256 columns, with warps in two roles. One producer warp
//   keeps TMA loads in flight into a ring of 192 KB (4 stages of depth
//   64), each stage
//   guarded by a "full" mbarrier (its bytes have landed) and an "empty"
//   one (every consumer warp is done with it): lhs as a 2-D tensor map
//   over (T, D), rhs as a 3-D map over (E, D, F) in boxes of 64 columns,
//   both in the 128-byte swizzle that wgmma reads; TMA zero-fills the D,
//   F and T edges (no padding copy), and boxes wholly past F are not
//   loaded. Two consumer warpgroups of 64 rows each issue a stage's four
//   wgmma.m64n256k16 back to back, commit them and wait with
//   wgmma.wait_group 1, so one stage's products overlap the next stage's
//   arrival, then release the stage before; no block-wide barrier after
//   the start. A tile's fp32 accumulators go out as bf16 through a
//   swizzled buffer of shared memory and TMA stores, which drain while the
//   consumers start the next tile's products (the producer is already
//   loading its stages); a warpgroup whose rows cross a run's end stores
//   its elements itself. Storing from registers straight to device memory
//   took a fifth of the time at deepseek's shapes (PERF.md). Row tiles are
//   cut per run of equal (clamped) expert, from
//   the run's first row, and never span two experts: the dropless path's
//   runs are whole multiples of block_t 128, so each is cut into whole
//   tiles; each warp finds the runs by walking tile_expert forward 32
//   entries at a time. Rows past a run's end are loaded but never stored;
//   a warpgroup whose rows all lie past it takes no products. The tiles'
//   order (row tile slow, column slab fast) keeps the CTAs at work at one
//   time on a few neighbouring row tiles, so lhs and each expert's
//   weights leave HBM about once. Shapes TMA cannot describe (D or F not
//   a multiple of 8, a base not 16-byte aligned) go to the narrow tile,
//   which takes any shape.
// - narrow (gmm_narrow_kernel; decode, 8 rows an expert): a CTA owns 8 rows
//   x 128 columns and computes out^T = rhs^T lhs^T with mma.sync.m16n8k16,
//   the 8 rows as the mma's n = 8 side (no padded rows), fed by ldmatrix
//   from rows padded by 16 bytes (no bank read twice), staged by 16-byte
//   cp.async copies in a ring of 4 stages; each thread's copy addresses
//   are set up once per run. Each CTA streams its expert's 128-column slab
//   once, 64 rows deep a stage, 52 KB in flight. It walks the runs of
//   equal expert among its 8 rows, one pass per run with the other rows'
//   lhs zero-filled, so any block_t is right. Every CTA walks all of D:
//   mixtral's decode w_down shape (D 16384) already makes 384 CTAs, and
//   splitting D over CTAs measured slower there. The F, D and T edges are
//   masked (zero-filled copies); where D or F is not a multiple of 8 (rows
//   not 16-byte aligned) both operands are staged by scalar loads instead.
// No atomics and no split of D: repeated calls give the same bits.
//
// Design, float32: fp32 FMAs on the CUDA cores, no TF32 (a CTA owns a
// BM x 256 tile, BM the largest of 64/32/16/8 dividing block_t,
// double-buffered fp32 chunks of 16).
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: fp32 FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------
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
void dispatch_fma(const void* lhs, const void* rhs, const int* te, void* out, int t, int d,
                  int f, int e, int block_t, cudaStream_t s) {
  if (block_t % 64 == 0) launch<T, 64>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else if (block_t % 32 == 0) launch<T, 32>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else if (block_t % 16 == 0) launch<T, 16>(lhs, rhs, te, out, t, d, f, e, block_t, s);
  else launch<T, 8>(lhs, rhs, te, out, t, d, f, e, block_t, s);
}

// ---------------------------------------------------------------------------
// bfloat16: the shared pieces and the narrow tile (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kStagesTc = 4;

struct GmmArgs {
  const bf16* lhs;
  const bf16* rhs;
  const int* tile_expert;
  bf16* out;
  int t, d, f, e, block_t;
  int lhs_vec, rhs_vec, out_vec2;
};

// The end of the run of equal (clamped) expert that starts at row r_lo, cut
// at row_end; its expert in *e.
__device__ __forceinline__ int run_end(const GmmArgs& g, int r_lo, int row_end, int* e) {
  const int tile = r_lo / g.block_t;
  *e = clamp_expert(g.tile_expert[tile], g.e);
  int r_hi = (tile + 1) * g.block_t;
  while (r_hi < row_end && clamp_expert(g.tile_expert[r_hi / g.block_t], g.e) == *e)
    r_hi += g.block_t;
  return min(r_hi, row_end);
}

// One ring stage: lhs rows [m0, m0 + ROWS) x depth [k0, k0 + BK) (rows
// outside [r_lo, r_hi) and depth past D as zeros) into a_s, row stride
// BK + 8; rhs_e depth rows [k0, k0 + BK) x columns [n0, n0 + BN) (depth past
// D and columns past F as zeros) into b_s, row stride BN + 8.
template <int THREADS, int ROWS, int BK, int BN>
__device__ __forceinline__ void stage_tiles(bf16* a_s, bf16* b_s, const GmmArgs& g,
                                            const bf16* rhs_e, int m0, int r_lo, int r_hi,
                                            int k0, int n0) {
  constexpr int AS = BK + 8, BS = BN + 8;
  const int k_end = g.d;
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * BK / 8; i += THREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int row = m0 + r, k = k0 + c;
    const bool row_in = row >= r_lo && row < r_hi;
    bf16* dst = a_s + r * AS + c;
    const bf16* src = g.lhs + static_cast<size_t>(row) * g.d + k;
    if (g.lhs_vec) {
      const int n = row_in ? max(0, min(8, k_end - k)) : 0;
      cp_async16(dst, n ? src : g.lhs, 2 * n);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = (row_in && k + v < k_end) ? src[v] : zero;
    }
  }
#pragma unroll
  for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int k = k0 + r, col = n0 + c;
    bf16* dst = b_s + r * BS + c;
    const bf16* src = rhs_e + static_cast<size_t>(k) * g.f + col;
    if (g.rhs_vec) {
      const int n = k < k_end ? max(0, min(8, g.f - col)) : 0;
      cp_async16(dst, n ? src : g.rhs, 2 * n);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = (k < k_end && col + v < g.f) ? src[v] : zero;
    }
  }
}

// The same stage where both operands have 16-byte rows (D and F multiples of
// 8), with each thread's chunks fixed for a run: their source pointers,
// advanced one stage at a time, and the bytes each copies (0 for rows
// outside the run and columns past F, zero-filled) are set up once, so a
// stage costs a thread a pointer add and a cp.async per chunk. `load` is
// called for consecutive stages from depth 0 on.
template <int THREADS, int ROWS, int BK, int BN>
struct Stager {
  static constexpr int AS = BK + 8, BS = BN + 8;
  static constexpr int AC = ROWS * BK / 8, BC = BK * BN / 8;  // 16-byte chunks of a stage
  static constexpr int AJ = (AC + THREADS - 1) / THREADS, BJ = (BC + THREADS - 1) / THREADS;
  const bf16* a_src[AJ];
  const bf16* b_src[BJ];
  int a_bytes[AJ], b_bytes[BJ];
  size_t b_step;

  __device__ __forceinline__ Stager(const GmmArgs& g, const bf16* rhs_e, int m0, int r_lo,
                                    int r_hi, int n0)
      : b_step(static_cast<size_t>(BK) * g.f) {
#pragma unroll
    for (int j = 0; j < AJ; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool in = i < AC && m0 + r >= r_lo && m0 + r < r_hi;
      a_src[j] = g.lhs + (in ? static_cast<size_t>(m0 + r) * g.d : 0) + c;
      a_bytes[j] = in ? 16 : 0;
    }
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int n = i < BC ? max(0, min(8, g.f - n0 - c)) : 0;
      b_src[j] = rhs_e + static_cast<size_t>(r) * g.f + (n ? n0 + c : 0);
      b_bytes[j] = 2 * n;
    }
  }

  __device__ __forceinline__ void load(bf16* a_s, bf16* b_s, int k0, int k_end) {
#pragma unroll
    for (int j = 0; j < AJ; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      if (AC % THREADS == 0 || i < AC)
        cp_async16(a_s + r * AS + c, a_src[j], k0 + c < k_end ? a_bytes[j] : 0);
      a_src[j] += BK;
    }
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      if (BC % THREADS == 0 || i < BC)
        cp_async16(b_s + r * BS + c, b_src[j], k0 + r < k_end ? b_bytes[j] : 0);
      b_src[j] += b_step;
    }
  }
};

__device__ __forceinline__ void put(const GmmArgs& g, int row, int col, float v) {
  g.out[static_cast<size_t>(row) * g.f + col] = __float2bfloat16(v);
}

// The K loop of one run through a ring of STAGES: stages are filled
// STAGES - 1 ahead of the one multiplied; `mul(a_s, b_s)` consumes a landed
// stage.
template <int THREADS, int ROWS, int BK, int BN, int STAGES, typename Mul>
__device__ __forceinline__ void run_k_loop(bf16* a_ring, bf16* b_ring, const GmmArgs& g,
                                           const bf16* rhs_e, int m0, int r_lo, int r_hi, int n0,
                                           Mul mul) {
  constexpr int A_ELEMS = ROWS * (BK + 8), B_ELEMS = BK * (BN + 8);
  const int nk = (g.d + BK - 1) / BK;
  const bool fast = g.lhs_vec && g.rhs_vec;
  Stager<THREADS, ROWS, BK, BN> stager(g, rhs_e, m0, r_lo, r_hi, n0);
  auto fill = [&](int st, int k0) {
    if (fast)
      stager.load(a_ring + st * A_ELEMS, b_ring + st * B_ELEMS, k0, g.d);
    else
      stage_tiles<THREADS, ROWS, BK, BN>(a_ring + st * A_ELEMS, b_ring + st * B_ELEMS, g, rhs_e,
                                         m0, r_lo, r_hi, k0, n0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) fill(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();              // ... and everyone's; stage kt - 1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) fill(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const int st = kt % STAGES;
    mul(a_ring + st * A_ELEMS, b_ring + st * B_ELEMS);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next run
}

// narrow: 8 rows x 128 columns, out^T = rhs^T lhs^T; warp w owns columns
// [32 w, 32 w + 32) as two m16 tiles; depth 64 a stage
constexpr int kNM = 8, kNN = 128, kNK = 64, kNThreads = 128;
constexpr size_t kNarrowSmem = kStagesTc * (kNM * (kNK + 8) + kNK * (kNN + 8)) * sizeof(bf16);

__global__ void __launch_bounds__(kNThreads) gmm_narrow_kernel(GmmArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_ring = reinterpret_cast<bf16*>(smem);
  bf16* b_ring = a_ring + kStagesTc * kNM * (kNK + 8);
  constexpr int AS = kNK + 8, BS = kNN + 8;
  const int m0 = blockIdx.x * kNM, n0 = blockIdx.y * kNN;
  const int row_end = min(m0 + kNM, g.t);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float acc[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[mi][v] = 0.f;

  auto mul = [&](const bf16* a_s, const bf16* b_s) {
#pragma unroll
    for (int kk = 0; kk < kNK; kk += 32) {
      unsigned lq[4];  // lhs^T fragments (the mma's B) of depth kk and kk + 16
      ldmatrix_x4(lq, a_s + (lane & 7) * AS + kk + (lane >> 3) * 8);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          unsigned af[4];  // rhs^T (the mma's A): 16 columns x 16 depth
          ldmatrix_x4_trans(af, b_s + (kk + 16 * s + (lane & 7) + ((lane >> 4) << 3)) * BS +
                                    warp * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[mi], af, lq[2 * s], lq[2 * s + 1]);
        }
    }
  };

  for (int r_lo = m0; r_lo < row_end;) {
    int e;
    const int r_hi = run_end(g, r_lo, row_end, &e);
    run_k_loop<kNThreads, kNM, kNK, kNN, kStagesTc>(
        a_ring, b_ring, g, g.rhs + static_cast<size_t>(e) * g.d * g.f, m0, r_lo, r_hi, n0, mul);
    r_lo = r_hi;
  }

  // fragment mi: columns +lane/4 and +8, rows 2 (lane % 4) and +1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = n0 + warp * 32 + mi * 16 + (lane >> 2) + 8 * (v >> 1);
      const int row = m0 + (lane & 3) * 2 + (v & 1);
      if (row < row_end && col < g.f) put(g, row, col, acc[mi][v]);
    }
}


// ---------------------------------------------------------------------------
// wide: persistent, warp-specialised, TMA-fed wgmma (sm_90a)
// ---------------------------------------------------------------------------
// A tile is 128 rows (two consumer warpgroups of 64) x 256 columns. A stage
// holds lhs 128 rows x 64 depth (K-major, one TMA box) and rhs 64 depth x
// 256 columns (N-major, four boxes of 64 columns), both in the
// 128-byte swizzle that TMA writes and wgmma reads: the 16-byte chunk c of
// a 128-byte row r sits at chunk c ^ (r % 8), each box on a 1 KB boundary.
constexpr int kWM = 128, kWN = 256, kWK = 64;
constexpr int kWConsumers = 256;             // two warpgroups
constexpr int kWThreads = kWConsumers + 32;  // and the producer warp
constexpr int kWABytes = kWM * kWK * 2;      // the lhs box of a stage, 16 KB
constexpr int kWBBox = kWK * 64 * 2;         // one rhs box, 8 KB
constexpr int kWStage = kWABytes + (kWN / 64) * kWBBox;  // 48 KB
constexpr int kWStages = 4;
constexpr int kWRing = kWStages * kWStage;  // 192 KB
// a consumer warpgroup's output buffer: 64 rows x 128 columns of bf16 as
// two boxes of 64 x 64 in the 128-byte swizzle, stored by TMA
constexpr int kWOutBox = 64 * 64 * 2, kWOut = 2 * kWOutBox;
// + both warpgroups' output buffers, the full and empty barriers, and room
// to align to 1 KB
constexpr size_t kWideSmem = kWRing + 2 * kWOut + 16 * kWStages + 1024;

struct WideMaps {  // TMA tensor maps: lhs (T, D), rhs (E, D, F), out (T, F)
  CUtensorMap lhs, rhs, out;
};

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// d (64 x 256, fp32) (+)= a (64 x 16, K-major) * b (16 x 256, N-major),
// bf16; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The runs of equal (clamped) expert in tile_expert, walked forward by one
// warp, each run cut into row tiles of kWM from its own first row. Every
// lane holds the same state; the lanes read 32 entries of the map at once.
struct RunWalk {
  int tile = 0;   // the run's first map entry
  int end = 0;    // one past its last
  int e = 0;      // its expert
  int first = 0;  // the index of its first row tile
  int parts = 0;  // its row tiles

  // the run that starts at `tile`
  __device__ __forceinline__ void load(const GmmArgs& g, int n_bt) {
    e = clamp_expert(__ldg(g.tile_expert + tile), g.e);
    end = n_bt;
    for (int base = tile + 1; base < n_bt; base += 32) {
      const int i = base + threadIdx.x % 32;
      const unsigned other = __ballot_sync(
          0xffffffffu, i < n_bt && clamp_expert(__ldg(g.tile_expert + i), g.e) != e);
      if (other) {
        end = base + __ffs(other) - 1;
        break;
      }
    }
    parts = ((end - tile) * g.block_t + kWM - 1) / kWM;
  }
  // Moves on to the run that holds row tile `mt` (this run or a later one);
  // false past the last run.
  __device__ __forceinline__ bool seek(const GmmArgs& g, int n_bt, int mt) {
    while (mt >= first + parts) {
      if (end >= n_bt) return false;
      first += parts;
      tile = end;
      load(g, n_bt);
    }
    return true;
  }
  __device__ __forceinline__ int row0(const GmmArgs& g, int mt) const {
    return tile * g.block_t + (mt - first) * kWM;
  }
};

// One CTA an SM walks the tiles idx = blockIdx.x, + gridDim.x, ...: row tile
// idx / n_slabs, column slab idx % n_slabs, so the CTAs at work at one time
// hold a few neighbouring row tiles across all their slabs: each lhs tile
// and each expert's weights leave HBM about once, the other reads hit L2.
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ WideMaps maps, const GmmArgs g) {
  constexpr int S = kWStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned out_s = ring + kWRing, full = out_s + 2 * kWOut, empty = full + 8 * S;
  const int n_bt = g.t / g.block_t, n_slabs = (g.f + kWN - 1) / kWN;
  const int nk = (g.d + kWK - 1) / kWK;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  RunWalk walk;
  walk.load(g, n_bt);
  int it = 0;  // stages through the ring so far, over all of this CTA's tiles

  if (threadIdx.x >= kWConsumers) {  // the producer warp: lane 0 issues every copy
    for (int idx = blockIdx.x;; idx += gridDim.x) {
      const int mt = idx / n_slabs, n0 = (idx % n_slabs) * kWN;
      if (!walk.seek(g, n_bt, mt)) break;
      const int m0 = walk.row0(g, mt);
      const int boxes = min(kWN / 64, (g.f - n0 + 63) / 64);  // boxes past F stay unread
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(empty + 8 * st, (it / S + 1) & 1);
        if (lane == 0) {
          const unsigned dst = ring + st * kWStage, bar = full + 8 * st;
          mbar_expect_tx(bar, kWABytes + boxes * kWBBox);
          tma_load(dst, &maps.lhs, bar, kt * kWK, m0);
          for (int j = 0; j < boxes; ++j)
            tma_load(dst + kWABytes + j * kWBBox, &maps.rhs, bar, n0 + 64 * j, kt * kWK, walk.e);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows [64 wg, 64 wg + 64) of each tile
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  float acc[kWN / 2];  // each tile's first products overwrite it
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
  for (int idx = blockIdx.x;; idx += gridDim.x) {
    const int mt = idx / n_slabs, n0 = (idx % n_slabs) * kWN;
    if (!walk.seek(g, n_bt, mt)) break;
    const int m0 = walk.row0(g, mt), row_end = min(m0 + kWM, walk.end * g.block_t);
    const bool active = m0 + 64 * wg < row_end;  // this warpgroup's rows hold part of the run
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % S;
      mbar_wait(full + 8 * st, (it / S) & 1);
      if (!active) {
        if (lane == 0) mbar_arrive(empty + 8 * st);
        continue;
      }
      // A: this warpgroup's 64 rows (8-row atoms 1 KB apart; depth steps of
      // 16 are 32 bytes into the swizzled row); B: boxes of 64 columns 8 KB
      // apart, of 8 depth rows 1 KB apart (depth steps of 16 are 2 KB)
      const unsigned a_addr = ring + st * kWStage + wg * 64 * 128;
      const unsigned b_addr = ring + st * kWStage + kWABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        wgmma_tile(acc, smem_desc(a_addr + 32 * kk, 0, 1024),
                   smem_desc(b_addr + 2048 * kk, kWBBox, 1024), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the products of the stage before are done ...
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));  // ... so it is free
    }
    if (!active) continue;
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));

    // accumulator: warp w of the warpgroup holds rows 16 w + lane / 4 (+ 8);
    // register 4 j (+ 1) is column 8 j + 2 (lane % 4) (+ 1), 4 j + 2 (+ 1)
    // the same columns 8 rows down. The producer is already loading the
    // next tile's stages.
    if (m0 + 64 * wg + 64 <= row_end) {
      // all 64 rows hold the run: 128 columns at a time into this
      // warpgroup's buffer (16-byte chunk c of row r at chunk c ^ (r % 8),
      // so the quads' stores hit 8 distinct chunks), then TMA stores them
      // (clipped at F) while the consumers go on to the next tile
      const unsigned buf = out_s + wg * kWOut;
      const bool issuer = threadIdx.x % 128 == 0;
#pragma unroll
      for (int r = 0; r < kWN / 128; ++r) {
        if (issuer) bulk_wait_read<0>();  // the last stores have read the buffer
        warpgroup_sync(wg);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + (lane >> 2) + 8 * h;
            const unsigned addr = buf + (j >> 3) * kWOutBox + row * 128 +
                                  (((j & 7) ^ (row & 7)) << 4) + 4 * (lane & 3);
            const int i = 4 * (16 * r + j) + 2 * h;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                         "r"(pack_bf16x2(acc[i], acc[i + 1]))
                         : "memory");
          }
        fence_proxy_async();
        warpgroup_sync(wg);
        if (issuer) {
          for (int b = 0; b < 2; ++b)
            if (n0 + 128 * r + 64 * b < g.f)
              tma_store(&maps.out, buf + b * kWOutBox, n0 + 128 * r + 64 * b, m0 + 64 * wg);
          bulk_commit();
        }
      }
      continue;
    }
    // rows past the run's end belong to another tile: element stores
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + 8 * j + (lane & 3) * 2;
        if (row >= row_end || col >= g.f) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (g.out_vec2 && col + 1 < g.f) {
          *reinterpret_cast<__nv_bfloat162*>(g.out + static_cast<size_t>(row) * g.f + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          put(g, row, col, v0);
          if (col + 1 < g.f) put(g, row, col + 1, v1);
        }
      }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<0>();  // this warpgroup's stores are done
}

// The SMs of the current device (the persistent grid), read once a device.
int sm_count() {
  static int count[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && count[dev] > 0) return count[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = std::max(n, 1);
  if (dev < kMaxDevices) count[dev] = n;
  return n;
}

// The wide tile, where TMA can describe both operands (rows of 16-byte
// multiples, 16-byte aligned bases; the wrapper sends other shapes to the
// narrow tile).
int launch_wide(const GmmArgs& g, cudaStream_t s) {
  if (!(g.lhs_vec && g.rhs_vec) || g.d <= 0 || !aligned16(g.out))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  WideMaps maps;
  const long long lhs_dims[2] = {g.d, g.t}, lhs_str[1] = {g.d};
  const long long rhs_dims[3] = {g.f, g.d, g.e};
  const long long rhs_str[2] = {g.f, static_cast<long long>(g.d) * g.f};
  const long long out_dims[2] = {g.f, g.t}, out_str[1] = {g.f};
  CUresult r = encode(fn, &maps.lhs, g.lhs, 2, lhs_dims, lhs_str, 1, kWM);
  if (r == CUDA_SUCCESS) r = encode(fn, &maps.rhs, g.rhs, 3, rhs_dims, rhs_str, 1, kWK);
  if (r == CUDA_SUCCESS) r = encode(fn, &maps.out, g.out, 2, out_dims, out_str, 1, 64);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  static bool smem_set[kMaxDevices];
  const cudaError_t err = allow_dynamic_smem(gmm_wgmma_kernel, kWideSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles cut per run: at most one per map entry when block_t <= kWM,
  // else ceil(T / kWM) + one a run
  const long long n_bt = g.t / g.block_t;
  const long long rows = g.block_t <= kWM ? n_bt : (g.t + kWM - 1) / kWM + n_bt;
  const long long tiles = rows * ((g.f + kWN - 1) / kWN);
  const int grid = static_cast<int>(std::min<long long>(sm_count(), tiles));
  gmm_wgmma_kernel<<<grid, kWThreads, kWideSmem, s>>>(maps, g);
  return static_cast<int>(cudaGetLastError());
}

// Launches the bf16 kernel of this row tile; each kernel is allowed its
// dynamic shared memory once per device, not on every call.
int launch_tc(const GmmArgs& g, int tile_rows, cudaStream_t s) {
  static bool narrow_smem[kMaxDevices];
  if (tile_rows == kWM) return launch_wide(g, s);
  if (tile_rows != kNM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_dynamic_smem(gmm_narrow_kernel, kNarrowSmem, narrow_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // fixed 8-row tiles
  const dim3 grid((g.t + kNM - 1) / kNM, (g.f + kNN - 1) / kNN);
  gmm_narrow_kernel<<<grid, kNThreads, kNarrowSmem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of the bf16 kernel for this row tile, in bytes (0
// for a tile it does not take).
extern "C" int moe_gmm_smem_bytes(int tile_rows) {
  return tile_rows == kWM ? static_cast<int>(kWideSmem)
         : tile_rows == kNM ? static_cast<int>(kNarrowSmem)
                            : 0;
}

// lhs (t, d), rhs (e, d, f), out (t, f) contiguous in `dtype`; tile_expert
// (t / block_t,) int32; t % block_t == 0. bf16 only: tile_rows 128 (wide;
// D and F multiples of 8, lhs and rhs 16-byte aligned) or 8 (narrow).
// Returns cudaGetLastError(), cudaErrorInvalidValue for arguments it does
// not take, or kEncodeError + the CUresult of cuTensorMapEncodeTiled where
// a tensor map cannot be encoded.
extern "C" int moe_gmm_launch(const void* lhs, const void* rhs, const void* tile_expert,
                              void* out, int t, int d, int f, int e, int block_t, int tile_rows,
                              int dtype, void* stream) {
  if (block_t <= 0 || e <= 0 || t % block_t != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  if (dtype == kF32) {
    dispatch_fma<float>(lhs, rhs, te, out, t, d, f, e, block_t, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const GmmArgs g{static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), te,
                  static_cast<bf16*>(out), t, d, f, e, block_t,
                  aligned16(lhs) && d % 8 == 0, aligned16(rhs) && f % 8 == 0,
                  (reinterpret_cast<uintptr_t>(out) & 3u) == 0 && f % 2 == 0};
  return launch_tc(g, tile_rows, s);
}
