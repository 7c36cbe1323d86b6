// Flash attention forward (causal or not, GQA, optional sliding window) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel). Same semantics: online softmax with fp32
// running (m, l, acc), masks by absolute index (k < Sk, causal k <= q, window
// k > q - window) filled with the finite NEG_INF = -1e9, l floored at 1e-30,
// query head h reads kv head h / (H / KV), output in q's dtype. Built for the
// head dims 8, 16, 32, 64, 80, 128 and 160 (every attention config's).
//
// Bound on the H100: 4 * H * D * (causal pairs) operations at the bf16
// tensor rate against q, k, v and o read or written once. At qwen2.5-3b's
// 512-token prefill (q (1, 16, 512, 128), 2 kv heads) that is 1.08 GFLOP
// (counted), 0.0011 ms at 989 TFLOP/s, against 4.7 MB, 0.0014 ms at
// 3.35 TB/s: the two bounds are close, so the products must run on the
// tensor cores and K/V must stream through shared memory without stalls;
// longer prompts are bound by operations.
//
// Design, bf16 (flash_tc_kernel; FlashAttention-2's shape, arXiv:2307.08691):
// a CTA of 8 warps owns 64 q rows of one (batch, head) and the K/V tiles of
// 64 keys from the first tile the window allows to the last tile causality
// allows. The warps form two halves of 4, 16 rows a warp: one half takes
// the even tiles, the other the odd ones, each with its own online softmax,
// so the heaviest q tile walks half as many steps and each SM sub-partition
// has two warps to switch between (one warp per sub-partition left every
// dependency exposed); at the end the odd half hands its (acc, m, l) to the
// even half through shared memory, lane for lane, and the even half merges
// and writes. Q is staged once in shared memory and its A fragments stay in
// registers; K/V tiles arrive in pairs by a two-stage ring of 16-byte
// cp.async copies (the next pair lands while this one is used).
// Rows are padded by 16 bytes, so the eight rows an ldmatrix reads start on
// eight different 4-bank groups (no conflicts). S = Q K^T runs on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators); the online softmax works
// on those fp32 fragments in registers, in the log2 domain (exp2 of scores
// pre-scaled by log2 e), with the row max and sum across the quad of lanes
// that share a row by two shuffles; masks by absolute index only on the
// tiles that cross a mask edge; l is summed from the fp32 P, and P goes to
// bf16 in registers as the A operand of P V (the accumulator's layout is
// the A fragment's), V read by ldmatrix.trans. Head dim 8 is zero-padded to
// 16 (the product's depth) in shared memory, which leaves the scores exact.
// Keys past Sk are zero-filled and masked. The causal grid launches the
// heaviest q tiles (the last ones) first, so the tail is short. Inputs are
// read through their (batch, head, seq) strides; where a base address or a
// stride is not 16-byte aligned, the tiles are staged by scalar loads.
//
// Design, float32 (flash_fwd_kernel, which the float32 parity checks rest
// on): fp32 FMAs on the CUDA cores; one block owns a 64-row q
// tile of one (batch, head); four threads share a q row, each holding D/4
// interleaved dims of q and of the accumulator in registers, partial dot
// products meeting by two xor shuffles; the K/V tile (32 keys, fp32) sits
// in shared memory.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e9f;

struct Strides {
  long long b, h, s;  // element strides of batch, head and sequence; dim stride is 1
};

// ---------------------------------------------------------------------------
// float32: fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int group, int sq,
                 int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale) {
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  static_assert(D % kThreadsPerRow == 0, "head_dim a multiple of 4");
  __shared__ float k_tile[kBlockK][D];
  __shared__ float v_tile[kBlockK][D];

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;  // 4 neighbouring lanes share a row
  const int part = tid % kThreadsPerRow;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / group;
  const int q_start = blockIdx.x * kBlockQ;
  const int qi = q_start + row;
  const bool row_ok = qi < sq;

  float qr[kDimsPerThread], acc[kDimsPerThread];
  const float* qp = q + b * qs.b + h * qs.h + static_cast<long long>(qi) * qs.s;
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    qr[i] = row_ok ? qp[part + kThreadsPerRow * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // k range this q tile needs: [lo, hi]
  int lo = 0;
  if (window > 0) lo = max(0, q_start - window + 1);
  int hi = sk - 1;
  if (causal) hi = min(hi, q_start + kBlockQ - 1);

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = (lo / kBlockK) * kBlockK; k0 <= hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      const bool in = kp < sk;  // zero-fill past Sk: p = 0 there, and 0 * 0 stays 0
      k_tile[j][c] = in ? kb[static_cast<long long>(kp) * ks.s + c] : 0.f;
      v_tile[j][c] = in ? vb[static_cast<long long>(kp) * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) dot += qr[i] * k_tile[j][part + kThreadsPerRow * i];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      bool ok = kp < sk;
      if (causal) ok = ok && kp <= qi;
      if (window > 0) ok = ok && kp > qi - window;
      s[j] = ok ? dot * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) a += s[j] * v_tile[j][part + kThreadsPerRow * i];
      acc[i] = a;
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = o + b * os.b + h * os.h + static_cast<long long>(qi) * os.s;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) op[part + kThreadsPerRow * i] = acc[i] * inv;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;     // q rows of a CTA, 16 a warp of each half
constexpr int kTcKeys = 64;     // keys of a K/V tile
constexpr int kTcThreads = 256; // two halves of 4 warps: even and odd key tiles
constexpr int kTcStages = 2;    // a stage holds a pair of K/V tiles

// D padded to the product's depth (16); rows padded by 8 elements (16 bytes)
template <int D>
struct TcShape {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int RS = DP + 8;
  static constexpr int kTile = kTcKeys * RS;  // elements of one K or V tile
  static constexpr int kRing = kTcStages * 4 * kTile;
  static constexpr size_t kSmem = sizeof(bf16) * (kTcRows * RS + kRing);
  // the odd half's (acc, m, l) of each lane, written over the ring at the end
  static constexpr int kMerge = DP / 2 + 4;
  static_assert(DP % 16 == 0 && D % 8 == 0, "head_dim 8 or a multiple of 16");
  static_assert(4 * 32 * kMerge * sizeof(float) <= kRing * sizeof(bf16), "merge area fits");
};

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int group, sq, sk, causal, window, vec;
  float scale_log2;  // scale * log2(e)
  Strides qs, ks, vs, os;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_tc_kernel(TcArgs a) {
  using S = TcShape<D>;
  constexpr int DP = S::DP, RS = S::RS, KSTEPS = DP / 16, NT_O = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][RS]
  bf16* kv_s = q_s + kTcRows * RS;                // [stage][tile of the pair][K | V][64][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp >> 2, wq = warp & 3;  // key tiles of this parity; q rows 16 wq
  const int g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int q_start = qt * kTcRows;
  const int kvh = h / a.group;

  if (DP != D) {  // the depth padding is never written by a copy: zero it once
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < (kTcRows + 4 * kTcStages * kTcKeys) * (DP - D); i += kTcThreads)
      q_s[(i / (DP - D)) * RS + D + i % (DP - D)] = zero;
  }

  int lo = a.window > 0 ? max(0, q_start - a.window + 1) : 0;
  int hi = a.sk - 1;
  if (a.causal) hi = min(hi, q_start + kTcRows - 1);
  const int t_lo = lo / kTcKeys;
  const int n_tiles = hi >= lo ? hi / kTcKeys - t_lo + 1 : 0;
  const int n_pairs = (n_tiles + 1) / 2;

  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + kvh * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + kvh * a.vs.h;
  const bool vec = a.vec != 0;
  auto load_pair = [&](int i, int st) {  // tiles 2 i and 2 i + 1 into stage st
    for (int t = 0; t < 2 && 2 * i + t < n_tiles; ++t) {
      const int k0 = (t_lo + 2 * i + t) * kTcKeys;
      bf16* ks = kv_s + (st * 2 + t) * 2 * S::kTile;
      stage_rows<RS, kTcThreads>(ks, kb, a.ks.s, k0, a.sk, D, vec, kTcRows);
      stage_rows<RS, kTcThreads>(ks + S::kTile, vb, a.vs.s, k0, a.sk, D, vec, kTcRows);
    }
  };

  stage_rows<RS, kTcThreads>(q_s, qb, a.qs.s, q_start, a.sq, D, vec, kTcRows);
  if (n_pairs > 0) load_pair(0, 0);
  cp_async_commit();

  unsigned qf[KSTEPS][4];
  float o_acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) o_acc[i][v] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // rows g and g + 8
  const int row0 = q_start + wq * 16 + g;                         // this lane's first row

  for (int i = 0; i < n_pairs; ++i) {
    if (i + 1 < n_pairs) load_pair(i + 1, (i + 1) % kTcStages);
    cp_async_commit();
    cp_async_wait<1>();  // pair i (and Q) landed: this thread's copies
    __syncthreads();     // ... and everyone's
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], q_s + (wq * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
    }
    const int j = 2 * i + half;  // this half's tile
    if (j < n_tiles) {
      const bf16* k_s = kv_s + ((i % kTcStages) * 2 + half) * 2 * S::kTile;
      const bf16* v_s = k_s + S::kTile;
      const int k0 = (t_lo + j) * kTcKeys;

      // S = Q K^T: 16 rows x 64 keys a warp, eight n-tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) s[n][v] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          unsigned kf[4];  // keys 16 n2 + [0, 8): b0 b1; keys 16 n2 + [8, 16): b0 b1
          ldmatrix_x4(kf, k_s + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
        }

      // online softmax on the fragments (log2 domain); masks only on edge tiles
      const bool edge = k0 + kTcKeys > a.sk || (a.causal && k0 + kTcKeys - 1 > q_start) ||
                        (a.window > 0 && k0 <= q_start + kTcRows - 1 - a.window);
      float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float x = s[n][v] * a.scale_log2;
          if (edge) {
            const int qi = row0 + 8 * (v >> 1), kp = k0 + 8 * n + 2 * c4 + (v & 1);
            bool ok = kp < a.sk;
            if (a.causal) ok = ok && kp <= qi;
            if (a.window > 0) ok = ok && kp > qi - a.window;
            if (!ok) x = kNegInf;
          }
          s[n][v] = x;
          m_cur[v >> 1] = fmaxf(m_cur[v >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
        m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
        const float m_new = fmaxf(m_run[r], m_cur[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      unsigned pa[4][4];  // P as the A operand of P V, one per 16 keys
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          s[n][v] = exp2f(s[n][v] - m_run[v >> 1]);
          l_run[v >> 1] += s[n][v];
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16x2(s[n][0], s[n][1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) o_acc[n][v] *= alpha[v >> 1];

      // O += P V: V (keys x D) as the B operand, read transposed
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int d2 = 0; d2 < DP / 16; ++d2) {
          unsigned vf[4];  // dims 16 d2 + [0, 8): b0 b1; dims 16 d2 + [8, 16): b0 b1
          ldmatrix_x4_trans(vf, v_s + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                    16 * d2 + (lane >> 4) * 8);
          mma_bf16(o_acc[2 * d2], pa[kk], vf[0], vf[1]);
          mma_bf16(o_acc[2 * d2 + 1], pa[kk], vf[2], vf[3]);
        }
    }
    __syncthreads();  // stage i % 2 is free for pair i + 2
  }
  cp_async_wait<0>();
  __syncthreads();

  // the odd half hands its (acc, m, l) to the even half's warp of the same
  // rows, lane for lane (the same fragment layout), over the ring
  float* merge = reinterpret_cast<float*>(kv_s) + (wq * 32 + lane) * S::kMerge;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) merge[4 * n + v] = o_acc[n][v];
    merge[DP / 2] = m_run[0];
    merge[DP / 2 + 1] = m_run[1];
    merge[DP / 2 + 2] = l_run[0];
    merge[DP / 2 + 3] = l_run[1];
  }
  __syncthreads();
  if (half == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = merge[DP / 2 + r], m = fmaxf(m_run[r], m1);
    a0[r] = exp2f(m_run[r] - m);
    a1[r] = exp2f(m1 - m);
    l_run[r] = l_run[r] * a0[r] + merge[DP / 2 + 2 + r] * a1[r];
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.sq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* op = a.o + b * a.os.b + h * a.os.h + static_cast<long long>(qi) * a.os.s;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = 8 * n + 2 * c4;
      const float o0 = o_acc[n][2 * r] * a0[r] + merge[4 * n + 2 * r] * a1[r];
      const float o1 = o_acc[n][2 * r + 1] * a0[r] + merge[4 * n + 2 * r + 1] * a1[r];
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(o0 * inv, o1 * inv);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int h,
                       int group, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), group, sq, sk, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int h,
                        int group, int sq, int sk, Strides qs, Strides ks, Strides vs,
                        Strides os, int causal, int window, float scale, cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_dynamic_smem(flash_tc_kernel<D>, TcShape<D>::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const bool strides16 = qs.b % 8 == 0 && qs.h % 8 == 0 && qs.s % 8 == 0 && ks.b % 8 == 0 &&
                         ks.h % 8 == 0 && ks.s % 8 == 0 && vs.b % 8 == 0 && vs.h % 8 == 0 &&
                         vs.s % 8 == 0;
  const int vec = strides16 && aligned16(q) && aligned16(k) && aligned16(v);
  const TcArgs args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), group, sq, sk, causal,
                    window, vec, scale * kLog2e, qs, ks, vs, os};
  const dim3 grid(h, b, (sq + kTcRows - 1) / kTcRows);
  flash_tc_kernel<D><<<grid, kTcThreads, TcShape<D>::kSmem, stream>>>(args);
  return cudaGetLastError();
}

int dispatch(int dtype, int d, const void* q, const void* k, const void* v, void* o, int b,
             int h, int group, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                                                 \
  case DIM:                                                                                   \
    return static_cast<int>(                                                                  \
        dtype == kF32 ? launch_f32<DIM>(q, k, v, o, b, h, group, sq, sk, qs, ks, vs, os,      \
                                        causal, window, scale, stream)                        \
                      : launch_bf16<DIM>(q, k, v, o, b, h, group, sq, sk, qs, ks, vs, os,     \
                                         causal, window, scale, stream));
  switch (d) {
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(160)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q: (B, H, Sq, D), k/v: (B, KV, Sk, D), o: (B, H, Sq, D), each given by its
// (batch, head, seq) element strides with a unit dim stride; in bf16, o's
// strides are even. window <= 0 means none. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unbuilt head_dim or dtype.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int h, int kv, int sq,
    int sk, int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (kv <= 0 || h % kv != 0 || (dtype != kF32 && dtype != kBF16) || b > 65535 ||
      (sq + kTcRows - 1) / kTcRows > 65535 ||
      (dtype == kBF16 && (o_sb % 2 != 0 || o_sh % 2 != 0 || o_ss % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  return dispatch(dtype, d, q, k, v, o, b, h, h / kv, sq, sk, qs, ks, vs, os, causal, window,
                  scale, static_cast<cudaStream_t>(stream));
}
