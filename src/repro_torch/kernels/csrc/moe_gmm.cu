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
// Design, bf16: products on the tensor cores with fp32 accumulators, from
// bf16 tiles that 16-byte cp.async copies stage in a ring of 4 shared-memory
// stages. Each CTA reads the tile_expert entries it needs itself. The
// wrapper picks one of two row tiles from T and E:
// - wide (gmm_wgmma_kernel; prefill, T >= 32 E): a CTA owns 192 rows x 128
//   columns, three warpgroups of 64 rows, each issuing wgmma.m64n128k16
//   from shared memory (lhs K-major, rhs N-major, both in the 128-byte
//   swizzle, written so by the copies; fence.proxy.async before the
//   products). Row tiles are cut per run of equal expert, from the run's
//   first row (a CTA scans tile_expert to find its tile), so a tile spans
//   several row tiles of one expert and never two: each of mixtral's
//   160-row runs is one tile, so one CTA streams each 128-column slab of an
//   expert's weights and rhs leaves HBM once. A warpgroup whose rows are
//   all past the run's end takes no products.
// - narrow (gmm_narrow_kernel; decode, 8 rows an expert): a CTA owns 8 rows
//   x 128 columns and computes out^T = rhs^T lhs^T with mma.sync.m16n8k16,
//   the 8 rows as the mma's n = 8 side (no padded rows), fed by ldmatrix
//   from rows padded by 16 bytes (no bank read twice); each thread's copy
//   addresses are set up once per run. Each CTA streams its expert's
//   128-column slab once, 64 rows deep a stage, 52 KB in flight. It walks
//   the runs of equal expert among its 8 rows, one pass per run with the
//   other rows' lhs zero-filled, so any block_t is right. Every CTA walks
//   all of D: mixtral's decode w_down shape (D 16384) already makes 384
//   CTAs, and splitting D over CTAs measured slower there.
// The F, D and T edges are masked in the kernel (zero-filled copies; no
// padding copy of rhs). Where D or F is not a multiple of 8 (rows not
// 16-byte aligned) both operands are staged by scalar loads instead. No
// atomics: repeated calls give the same bits.
//
// Design, float32: fp32 FMAs on the CUDA cores, no TF32 (a CTA owns a
// BM x 256 tile, BM the largest of 64/32/16/8 dividing block_t,
// double-buffered fp32 chunks of 16).
#include <stdint.h>

#include "common.cuh"

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
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
// wide: wgmma (sm_90a), 3 warpgroups of 64 rows x 128 columns
// ---------------------------------------------------------------------------
// A stage holds lhs 192 rows x 64 depth (K-major) and rhs 64 depth x 128
// columns (N-major, two atoms of 64 columns), both in the 128-byte swizzle:
// the 16-byte chunk c of a 128-byte row r sits at chunk c ^ (r % 8), and
// atoms of 8 such rows (1 KB) start on 1 KB boundaries. 40 KB a stage, 4
// stages: one CTA an SM.
constexpr int kGWarpgroups = 3, kGM = 64 * kGWarpgroups, kGN = 128, kGK = 64, kGStages = 4;
constexpr int kGThreads = 128 * kGWarpgroups;
constexpr size_t kGStage = (kGM * kGK + kGK * kGN) * sizeof(bf16);
constexpr size_t kGSmem = kGStages * kGStage + 1024;  // + room to align to 1 KB

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// make this thread's generic-proxy shared-memory writes (cp.async, st.shared)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, fp32) += a (64 x 16, K-major) * b (16 x N, N-major), bf16
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(1));
}
// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One stage of the wide tile: lhs rows [m0, row_end) x depth [k0, k0 + 64)
// and rhs_e depth [k0, k0 + 64) x columns [n0, n0 + 128) into the swizzled
// layout, zeros past the edges; cp.async where both operands have 16-byte
// rows, scalar loads otherwise.
__device__ __forceinline__ void wg_stage(unsigned char* st, const GmmArgs& g, const bf16* rhs_e,
                                         int m0, int row_end, int k0, int n0) {
  constexpr int BM = kGM, BN = kGN, THREADS = kGThreads;
  bf16* a_s = reinterpret_cast<bf16*>(st);
  bf16* b_s = reinterpret_cast<bf16*>(st + BM * kGK * sizeof(bf16));
  const bool vec = g.lhs_vec && g.rhs_vec;
  const int k_end = g.d;
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int j = 0; j < (BM * kGK / 8 + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS, r = i / 8, c = i % 8;
    if (i >= BM * kGK / 8) break;
    const int row = m0 + r, k = k0 + 8 * c;
    bf16* dst = a_s + r * kGK + 8 * (c ^ (r & 7));
    const bf16* src = g.lhs + static_cast<size_t>(row) * g.d + k;
    const bool in = row < row_end;
    if (vec) {
      const bool ok = in && k < k_end;
      cp_async16(dst, ok ? src : g.lhs, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = (in && k + v < k_end) ? src[v] : zero;
    }
  }
#pragma unroll
  for (int j = 0; j < (kGK * BN / 8 + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS, kr = i / (BN / 8), cc = i % (BN / 8);
    if (i >= kGK * BN / 8) break;
    const int atom = cc / 8, c = cc % 8;
    const int k = k0 + kr, col = n0 + 8 * cc;
    bf16* dst = b_s + atom * (kGK * 64) + kr * 64 + 8 * (c ^ (kr & 7));
    const bf16* src = rhs_e + static_cast<size_t>(k) * g.f + col;
    if (vec) {
      const int n = k < k_end ? max(0, min(8, g.f - col)) : 0;
      cp_async16(dst, n ? src : g.rhs, 2 * n);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = (k < k_end && col + v < g.f) ? src[v] : zero;
    }
  }
}

__global__ void __launch_bounds__(kGThreads) gmm_wgmma_kernel(GmmArgs g) {
  constexpr int BM = kGM, STAGES = kGStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n0 = blockIdx.y * kGN;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  // this CTA's row tile: the blockIdx.x-th of the runs' tiles, each run of
  // equal expert cut into tiles of BM rows from its own first row
  int m0 = -1, row_end = 0, e = 0;
  for (int tile = 0, x = blockIdx.x, n_tiles = g.t / g.block_t; tile < n_tiles;) {
    e = clamp_expert(g.tile_expert[tile], g.e);
    int end = tile + 1;
    while (end < n_tiles && clamp_expert(g.tile_expert[end], g.e) == e) ++end;
    const int rows = (end - tile) * g.block_t, parts = (rows + BM - 1) / BM;
    if (x < parts) {
      m0 = tile * g.block_t + x * BM;
      row_end = min(m0 + BM, end * g.block_t);
      break;
    }
    x -= parts;
    tile = end;
  }
  if (m0 < 0) return;  // the grid is sized for the most tiles any map can need
  const bf16* rhs_e = g.rhs + static_cast<size_t>(e) * g.d * g.f;
  const bool active = m0 + wg * 64 < row_end;  // this warpgroup's rows hold the run

  float acc[kGN / 2];
#pragma unroll
  for (int i = 0; i < kGN / 2; ++i) acc[i] = 0.f;

  // the ring: stages are filled STAGES - 1 ahead of the one multiplied
  const int nk = (g.d + kGK - 1) / kGK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) wg_stage(smem + s * kGStage, g, rhs_e, m0, row_end, s * kGK, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    fence_proxy_async();          // ... visible to wgmma's reads
    __syncthreads();              // ... everyone's; stage kt - 1's products are done
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) wg_stage(smem + (nxt % STAGES) * kGStage, g, rhs_e, m0, row_end, nxt * kGK, n0);
    cp_async_commit();
    if (active) {
      // A: this warpgroup's 64 rows (8-row atoms 1 KB apart; depth steps of
      // 16 are 32 bytes into the swizzled row); B: atoms of 64 columns 8 KB
      // apart, of 8 depth rows 1 KB apart (depth steps of 16 are 2 KB)
      const unsigned a_addr = smem_u32(smem + (kt % STAGES) * kGStage) + wg * 64 * kGK * 2;
      const unsigned b_addr = smem_u32(smem + (kt % STAGES) * kGStage) + BM * kGK * 2;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGK / 16; ++kk)
        wgmma_n128(acc, smem_desc(a_addr + 32 * kk, 0, 1024),
                   smem_desc(b_addr + 2048 * kk, kGK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // accumulator: warp w of the warpgroup holds rows 16 w + lane / 4 (+ 8);
  // register 4 j (+ 1) is column 8 j + 2 (lane % 4) (+ 1), 4 j + 2 (+ 1) the
  // same columns 8 rows down
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < kGN / 8; ++j)
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

// Launches the bf16 kernel of this row tile; each kernel is allowed its
// dynamic shared memory once per device, not on every call.
int launch_tc(const GmmArgs& g, int tile_rows, cudaStream_t s) {
  static bool narrow_smem[kMaxDevices], wide_smem[kMaxDevices];
  cudaError_t err;
  if (tile_rows == kNM) {
    err = allow_dynamic_smem(gmm_narrow_kernel, kNarrowSmem, narrow_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // fixed 8-row tiles
    const dim3 grid((g.t + kNM - 1) / kNM, (g.f + kNN - 1) / kNN);
    gmm_narrow_kernel<<<grid, kNThreads, kNarrowSmem, s>>>(g);
  } else if (tile_rows == kGM) {
    err = allow_dynamic_smem(gmm_wgmma_kernel, kGSmem, wide_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // tiles cut per run: at most one per row tile of block_t rows when
    // block_t <= kGM, else ceil(T / kGM) + one a run
    const int n_bt = g.t / g.block_t;
    const int n_rows = g.block_t <= kGM ? n_bt : (g.t + kGM - 1) / kGM + n_bt;
    gmm_wgmma_kernel<<<dim3(n_rows, (g.f + kGN - 1) / kGN), kGThreads, kGSmem, s>>>(g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of the bf16 kernel for this row tile, in bytes (0
// for a tile it does not take).
extern "C" int moe_gmm_smem_bytes(int tile_rows) {
  return tile_rows == kGM ? static_cast<int>(kGSmem)
         : tile_rows == kNM ? static_cast<int>(kNarrowSmem)
                            : 0;
}

// lhs (t, d), rhs (e, d, f), out (t, f) contiguous in `dtype`; tile_expert
// (t / block_t,) int32; t % block_t == 0. bf16 only: tile_rows 192 (wide)
// or 8 (narrow). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.
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
