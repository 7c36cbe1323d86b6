// Paged decode attention (one query token per sequence, GQA) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention / _paged_kernel). Same semantics: q (B, H, D) attends
// over the K/V of its sequence, which live in fixed-size blocks of shared
// pools (NB, BS, KV, D) reachable only through the row's block table
// (B, MAXB); the first context_lens[b] positions are valid, blocks past them
// are skipped, positions past them inside the last block are masked with the
// finite NEG_INF = -1e9; the online softmax keeps (m, l, acc) in fp32, the
// output is acc / max(l, 1e-30) in q's dtype, so a row with length 0 comes
// out as zeros. Query head h reads kv head h / (H / KV).
//
// Bound on the H100: bytes. A decode query reads each valid K/V position
// once (2 * len * KV * D elements per row) and does 4 * H * D FLOPs per
// position, about 2 FLOPs per byte at bf16, far below the ~295 where the
// tensor cores would be the limit. At the main path's decode wave (8 rows x
// 2 kv heads) the grid has only 16 blocks for 132 SMs, so this first kernel
// sits far from that bound; splitting each row's blocks over several CTAs
// (flash-decoding) with a second combine pass is the lever for a later PR.
//
// Design: the TPU kernel walks a sequential grid axis over the table and
// carries (m, l, acc) in VMEM scratch, with the table as a scalar-prefetch
// operand. Here one CTA owns one (row b, kv head) and the whole query group
// G = H / KV, one warp per query head, and walks the row's blocks in an
// inner loop, reading tables[b, j] itself for j < ceil(len / BS) only. q is
// staged in shared memory as fp32. For each block (in pieces of 32 slots
// when BS > 32) lane t scores slot t against the whole q row, the warp takes
// the block's max and sum by shuffles, and then each lane accumulates its
// own D / 32 interleaved dims of p . V, with p broadcast from the lane that
// scored it. Warps never wait on each other (no __syncthreads); the G warps
// of a CTA read the same K/V rows, which the first one brings into L1.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kWarp = 32;
constexpr int kMaxGroup = 32;  // one warp per query head: at most 1024 threads

struct PagedArgs {
  const int* tables;    // (B, MAXB) int32, row stride t_sb
  const int* lens;      // (B,) int32
  int maxb, bs, group;
  long long q_sb, q_sh;           // q strides: batch, head (dim stride 1)
  long long k_sb, k_ss, k_sh;     // pool strides: block, slot, kv head
  long long v_sb, v_ss, v_sh;
  long long t_sb;
  long long o_sb, o_sh;
  float scale;
};

template <typename T, int D>
__global__ void paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool, T* __restrict__ o,
                                       PagedArgs a) {
  constexpr int kPer = (D + kWarp - 1) / kWarp;  // dims each lane accumulates
  extern __shared__ float q_s[];                 // (group, D) fp32
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int h = kvh * a.group + g;

  float* qg = q_s + g * D;
  const T* qp = q + b * a.q_sb + h * a.q_sh;
  for (int c = lane; c < D; c += kWarp) qg[c] = to_f32(qp[c]);
  __syncwarp();

  const int len = a.lens[b];
  const int nblk = min((max(len, 0) + a.bs - 1) / a.bs, a.maxb);
  const int* table = a.tables + b * a.t_sb;

  float m = kNegInf, l = 0.f;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const long long bid = table[j];
    const T* kb = k_pool + bid * a.k_sb + kvh * a.k_sh;
    const T* vb = v_pool + bid * a.v_sb + kvh * a.v_sh;
    const int n_in = min(a.bs, len - j * a.bs);  // valid slots of this block, >= 1
    for (int c0 = 0; c0 < n_in; c0 += kWarp) {
      const int t = c0 + lane;
      float s = kNegInf;  // slots past the length (or the block) are masked
      if (t < n_in) {
        const T* kr = kb + t * a.k_ss;
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) dot += qg[c] * to_f32(kr[c]);
        s = dot * a.scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = t < n_in ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
      const int n_here = min(kWarp, n_in - c0);
      for (int u = 0; u < n_here; ++u) {
        const float pu = __shfl_sync(0xffffffffu, p, u);
        const T* vr = vb + (c0 + u) * a.v_ss;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int c = lane + i * kWarp;
          if (D % kWarp == 0 || c < D) acc[i] += pu * to_f32(vr[c]);
        }
      }
      m = m_new;
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + i * kWarp;
    if (D % kWarp == 0 || c < D) op[c] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int b, int kv,
            const PagedArgs& a, cudaStream_t stream) {
  const dim3 grid(kv, b);
  const size_t smem = static_cast<size_t>(a.group) * D * sizeof(float);
  paged_attention_kernel<T, D><<<grid, a.group * kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), a);
}

template <typename T>
int dispatch_dim(int d, const void* q, const void* k, const void* v, void* o, int b, int kv,
                 const PagedArgs& a, cudaStream_t stream) {
#define REPRO_PAGED_CASE(DIM)                      \
  case DIM:                                        \
    launch<T, DIM>(q, k, v, o, b, kv, a, stream);  \
    return 0;
  switch (d) {
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(32)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(80)
    REPRO_PAGED_CASE(128)
    default:
      return 1;
  }
#undef REPRO_PAGED_CASE
}

}  // namespace

// q: (B, H, D) by its (batch, head) element strides; k_pool/v_pool:
// (NB, BS, KV, D) by their (block, slot, head) strides; every dim stride is
// 1. tables: (B, MAXB) int32 with row stride t_sb; lens: (B,) int32 on the
// device; o: (B, H, D) by its (batch, head) strides. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unbuilt head_dim or
// dtype, H % KV != 0, or more than 32 query heads per kv head.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lens, void* o, int b, int h, int kv, int d, int bs, int maxb,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long t_sb, long long o_sb,
    long long o_sh, float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if (kv <= 0 || h % kv != 0 || h / kv > kMaxGroup || bs <= 0 || maxb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{static_cast<const int*>(tables), static_cast<const int*>(lens), maxb, bs,
                    h / kv, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, t_sb, o_sb, o_sh,
                    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad;
  if (dtype == kF32)
    bad = dispatch_dim<float>(d, q, k_pool, v_pool, o, b, kv, a, s);
  else if (dtype == kBF16)
    bad = dispatch_dim<__nv_bfloat16>(d, q, k_pool, v_pool, o, b, kv, a, s);
  else
    bad = 1;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
