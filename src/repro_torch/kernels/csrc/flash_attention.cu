// Flash attention forward (causal or not, GQA, optional sliding window) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel). Same semantics: online softmax with fp32
// running (m, l, acc), masks by absolute index (k < Sk, causal k <= q, window
// k > q - window) filled with the finite NEG_INF = -1e9, l floored at 1e-30,
// query head h reads kv head h / (H / KV), output in q's dtype.
//
// Bound on the H100: 4 * H * D * (causal pairs) FLOPs at the bf16 tensor
// rate against q, k, v and o read or written once; at the main path's
// 512-token prefill the two bounds are close, and longer prompts are bound
// by operations. This first version is simple and right, not fast: it runs the
// products as fp32 FMAs on the CUDA cores (fp32 keeps the float32 parity of
// the tests), not on the tensor cores; mma/wgmma and TMA are for a later PR.
//
// Design: the TPU kernel walks a sequential k grid axis and carries (m, l,
// acc) in VMEM scratch; here one block owns a 64-row q tile of one (batch,
// head) and walks the k tiles in an inner loop, from the first tile the
// window allows to the last that causality allows, skipping the rest. Four
// threads share a q row: each holds D/4 interleaved dims of q and of the
// accumulator in registers, partial dot products meet by two xor shuffles,
// and the K/V tile (32 keys, fp32) sits in shared memory, where the four
// threads of a row read neighbouring banks and the eight rows of a warp
// read the same words (a broadcast). Inputs are read through their strides,
// so the (B, S, H, D) projections need no transposed copy.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;

struct Strides {
  long long b, h, s;  // element strides of batch, head and sequence; dim stride is 1
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group, int sq,
                 int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale) {
  constexpr int kDimsPerThread = D / kThreadsPerRow;
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
  const T* qp = q + b * qs.b + h * qs.h + static_cast<long long>(qi) * qs.s;
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    qr[i] = row_ok ? to_f32(qp[part + kThreadsPerRow * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // k range this q tile needs: [lo, hi]
  int lo = 0;
  if (window > 0) lo = max(0, q_start - window + 1);
  int hi = sk - 1;
  if (causal) hi = min(hi, q_start + kBlockQ - 1);

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = (lo / kBlockK) * kBlockK; k0 <= hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int kp = k0 + j;
      const bool in = kp < sk;  // zero-fill past Sk: p = 0 there, and 0 * 0 stays 0
      k_tile[j][c] = in ? to_f32(kb[static_cast<long long>(kp) * ks.s + c]) : 0.f;
      v_tile[j][c] = in ? to_f32(vb[static_cast<long long>(kp) * vs.s + c]) : 0.f;
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
    T* op = o + b * os.b + h * os.h + static_cast<long long>(qi) * os.s;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) op[part + kThreadsPerRow * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int b, int h, int group,
            int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os, int causal,
            int window, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), group, sq, sk, qs, ks, vs, os, causal, window, scale);
}

template <typename T>
int dispatch_dim(int d, const void* q, const void* k, const void* v, void* o, int b, int h,
                 int group, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                                          \
  case DIM:                                                                            \
    launch<T, DIM>(q, k, v, o, b, h, group, sq, sk, qs, ks, vs, os, causal, window, \
                   scale, stream);                                                     \
    return 0;
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    default:
      return 1;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q: (B, H, Sq, D), k/v: (B, KV, Sk, D), o: (B, H, Sq, D), each given by its
// (batch, head, seq) element strides with a unit dim stride. window <= 0 means
// none. Returns cudaGetLastError(), or cudaErrorInvalidValue for an unbuilt
// head_dim or dtype.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int h, int kv, int sq,
    int sk, int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const int group = h / kv;
  int bad;
  if (dtype == kF32)
    bad = dispatch_dim<float>(d, q, k, v, o, b, h, group, sq, sk, qs, ks, vs, os, causal,
                              window, scale, s);
  else if (dtype == kBF16)
    bad = dispatch_dim<__nv_bfloat16>(d, q, k, v, o, b, h, group, sq, sk, qs, ks, vs, os,
                                      causal, window, scale, s);
  else
    bad = 1;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
