// Paged decode attention (one query token per sequence, GQA) for Hopper
// (sm_90a), split over each row's positions ("flash-decoding").
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention / _paged_kernel). Same semantics: q (B, H, D) attends
// over the K/V of its sequence, which live in fixed-size blocks of shared
// pools (NB, BS, KV, D) reachable only through the row's block table
// (B, MAXB); the first context_lens[b] positions are valid (at most
// MAXB * BS count), blocks past them are never read, positions past them
// are masked with the finite NEG_INF = -1e9; the softmax keeps (m, l, acc)
// in fp32, the output is acc / max(l, 1e-30) in q's dtype, so a row of
// length 0 comes out as zeros. Query head h reads kv head h / (H / KV).
// Built for the head dims 8, 16, 32, 64, 80, 128 and 160 (every attention
// config's); a K/V row is whole 16-byte chunks at each of them.
//
// Bound on the H100: bytes. A decode query reads each valid K/V position
// once (2 * len * KV * D elements per row) and does 4 * H * D FLOPs per
// position, about 2 FLOPs per byte at bf16, far below the ~295 where the
// tensor cores would be the limit. At the main path's decode wave (8 rows,
// 2 kv heads, lengths up to 640) that is 1.75 MB, half a microsecond at
// 3.35 TB/s: the kernel is bound by latency and by how much of the card it
// keeps busy, so the design is about parallelism and bytes in flight.
//
// Design. Pass 1 (paged_split_kernel): the grid is (kv head, row, split);
// a split covers `bps` consecutive table blocks (about 32 positions),
// chosen by the wrapper from the table width and the batch so that the main
// wave puts 320 CTAs on 132 SMs (one CTA per (row, kv head) would be 16). A
// split past the row's length writes the empty partial (m = -1e9, l = 0)
// and exits. A CTA of 4 warps owns the whole query group G = H / KV, whose
// q rows it keeps in shared memory as fp32, and walks its positions in
// tiles of 32: each tile's K and V rows (whichever blocks they lie in; any
// BS) are copied into a ring of 3 shared-memory stages with 16-byte
// cp.async, two tiles ahead of the one being used. Scores: a team of 16
// lanes reads one K row from shared memory, neighbouring lanes on
// neighbouring 16 bytes, and reduces its dot products with all q rows of
// the group by shuffles, the heads unrolled (instantiations for groups of
// up to 2, 8 and 32) so the reductions overlap. Softmax: one lane per
// position, the running (m, l) of each head in shared memory. p . V: each
// thread owns fixed (head, dim) outputs and reads V rows along dim. Each
// split writes its fp32 partial (m, l, acc[D]) of every head to scratch
// the wrapper allocated. Pass 2 (paged_combine_kernel): one CTA per (head,
// row) merges the splits that hold positions in split order (no atomics,
// so repeated calls give the same bits) and writes acc / max(l, 1e-30).
// With one split, pass 1 writes the output itself and pass 2 is not
// launched.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxGroup = 32;       // query heads per kv head
constexpr int kTile = 32;           // positions a stage holds: one per lane in the softmax
constexpr int kStages = 3;          // ring depth: two tiles in flight beside the one in use
constexpr int kTeam = 16;           // lanes that score one K row together
constexpr int kTeams = kThreads / kTeam;

struct PagedArgs {
  const int* tables;    // (B, MAXB) int32, row stride t_sb
  const int* lens;      // (B,) int32
  int maxb, bs, group, n_heads;
  int bps, n_splits;    // table blocks per split, splits per row
  int vec;              // K/V rows may be copied as 16-byte chunks
  long long q_sb, q_sh;           // q strides: batch, head (dim stride 1)
  long long k_sb, k_ss, k_sh;     // pool strides: block, slot, kv head
  long long v_sb, v_ss, v_sh;
  long long t_sb;
  long long o_sb, o_sh;
  float scale;
};

__device__ __forceinline__ int valid_len(const PagedArgs& a, int b) {
  return min(max(a.lens[b], 0), a.maxb * a.bs);
}

size_t split_smem_bytes(int d, int group, size_t elt) {
  return kStages * 2 * kTile * d * elt + sizeof(float) * (group * d + group * kTile + 3 * group);
}

// GM: the group size this instantiation is unrolled for (G <= GM)
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, T* __restrict__ o,
                   float* __restrict__ part_acc, float* __restrict__ part_ml, PagedArgs a) {
  constexpr int kVec = 16 / sizeof(T);               // elements of a 16-byte chunk
  constexpr int kChunks = D / kVec;                  // chunks of one K/V row
  constexpr int kTeamIters = (kChunks + kTeam - 1) / kTeam;
  constexpr int kAcc = (GM * D + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0, "a K/V row is whole 16-byte chunks");

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);                                   // [stage][K|V][kTile][D]
  float* q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTile * D);  // [G][D]
  float* p_s = q_s + a.group * D;                                         // [G][kTile]
  float* m_s = p_s + a.group * kTile;                                     // [G]
  float* l_s = m_s + a.group;
  float* alpha_s = l_s + a.group;

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int G = a.group, GD = a.group * D;
  const int len = valid_len(a, b);
  const int s0 = split * a.bps * a.bs, s1 = min(s0 + a.bps * a.bs, len);
  const bool direct = a.n_splits == 1;

  if (s0 >= s1) {  // past the row's length: the empty partial (or zeros)
    if (direct) {
      for (int i = tid; i < GD; i += kThreads)
        o[b * a.o_sb + (kvh * G + i / D) * a.o_sh + i % D] = from_f32<T>(0.f);
    } else {
      for (int g = tid; g < G; g += kThreads) {
        const size_t r = (static_cast<size_t>(b) * a.n_heads + kvh * G + g) * a.n_splits + split;
        part_ml[2 * r] = kNegInf;
        part_ml[2 * r + 1] = 0.f;
      }
    }
    return;
  }

  const int* table = a.tables + b * a.t_sb;
  // positions [s0 + tile * kTile, ...) of K and V into ring stage `stage`
  auto load_tile = [&](int tile, int stage) {
    const int p0 = s0 + tile * kTile, n = min(kTile, s1 - p0);
    T* ks = kv_s + stage * 2 * kTile * D;
    T* vs = ks + kTile * D;
    for (int i = tid; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      const int pos = p0 + r, j = pos / a.bs, slot = pos - j * a.bs;
      const long long bid = table[j];
      const T* kp = k_pool + bid * a.k_sb + slot * a.k_ss + kvh * a.k_sh + c;
      const T* vp = v_pool + bid * a.v_sb + slot * a.v_ss + kvh * a.v_sh + c;
      if (a.vec) {
        cp_async16(ks + r * D + c, kp);
        cp_async16(vs + r * D + c, vp);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          ks[r * D + c + v] = kp[v];
          vs[r * D + c + v] = vp[v];
        }
      }
    }
  };

  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  const T* qp = q + b * a.q_sb + kvh * G * a.q_sh;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = to_f32(qp[(i / D) * a.q_sh + i % D]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int team = tid / kTeam, tl = tid % kTeam;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; stage (t - 1) % kStages is free
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const T* ks = kv_s + (t % kStages) * 2 * kTile * D;
    const T* vs = ks + kTile * D;
    const int n = min(kTile, s1 - (s0 + t * kTile));

    // scores: team `team` takes rows team, team + kTeams, ... (same trip
    // count on every lane, so the shuffles see the whole warp)
    for (int r = team; r < kTile; r += kTeams) {
      const bool row_in = r < n;
      uint4 kc[kTeamIters];
#pragma unroll
      for (int i = 0; i < kTeamIters; ++i) {
        const int c = tl + i * kTeam;
        if (row_in && c < kChunks) kc[i] = *reinterpret_cast<const uint4*>(ks + r * D + c * kVec);
      }
      // the group's GM heads at once (unrolled, independent chains)
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        dot[g] = 0.f;
#pragma unroll
        for (int i = 0; i < kTeamIters; ++i) {
          const int c = tl + i * kTeam;
          if (g < G && row_in && c < kChunks) {
            const T* kv = reinterpret_cast<const T*>(&kc[i]);
            const float4* qq = reinterpret_cast<const float4*>(q_s + g * D + c * kVec);
#pragma unroll
            for (int v4 = 0; v4 < kVec / 4; ++v4) {
              const float4 qv = qq[v4];
              dot[g] += qv.x * to_f32(kv[4 * v4]) + qv.y * to_f32(kv[4 * v4 + 1]) +
                        qv.z * to_f32(kv[4 * v4 + 2]) + qv.w * to_f32(kv[4 * v4 + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int off = kTeam / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (row_in && tl == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) p_s[g * kTile + r] = dot[g] * a.scale;
      }
    }
    __syncthreads();

    // online softmax, one lane per position: warp w takes heads w, w + 4, ...
    for (int g = warp; g < G; g += kWarps) {
      const bool in = lane < n;
      const float s = in ? p_s[g * kTile + lane] : kNegInf;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = in ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // p . V: thread tid owns outputs tid + i * kThreads of the (G, D) tile
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int oi = tid + i * kThreads;
      if (oi < GD) acc[i] *= alpha_s[oi / D];
    }
    for (int r = 0; r < n; ++r) {
      const T* vr = vs + r * D;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int oi = tid + i * kThreads;
        if (oi < GD) acc[i] += p_s[(oi / D) * kTile + r] * to_f32(vr[oi % D]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int oi = tid + i * kThreads;
    if (oi >= GD) break;
    const int g = oi / D, c = oi % D;
    if (direct) {
      o[b * a.o_sb + (kvh * G + g) * a.o_sh + c] = from_f32<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
    } else {
      const size_t r = (static_cast<size_t>(b) * a.n_heads + kvh * G + g) * a.n_splits + split;
      part_acc[r * D + c] = acc[i];
      if (c == 0) {
        part_ml[2 * r] = m_s[g];
        part_ml[2 * r + 1] = l_s[g];
      }
    }
  }
}

// One CTA per (head, row): merge the splits that hold positions, in order.
template <typename T, int D>
__global__ void paged_combine_kernel(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml, T* __restrict__ o,
                                     PagedArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int span = a.bps * a.bs;
  const int used = (valid_len(a, b) + span - 1) / span;
  const size_t r0 = (static_cast<size_t>(b) * a.n_heads + h) * a.n_splits;
  float m = kNegInf;
  for (int s = 0; s < used; ++s) m = fmaxf(m, part_ml[2 * (r0 + s)]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) l += part_ml[2 * (r0 + s) + 1] * expf(part_ml[2 * (r0 + s)] - m);
  l = fmaxf(l, 1e-30f);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < used; ++s)
      acc += part_acc[(r0 + s) * D + c] * expf(part_ml[2 * (r0 + s)] - m);
    o[b * a.o_sb + h * a.o_sh + c] = from_f32<T>(acc / l);
  }
}

// Pass 1 unrolled for groups of up to GM; the kernel is allowed the shared
// memory of its largest group once per device, not on every call.
template <typename T, int D, int GM>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o, float* part_acc,
                         float* part_ml, int b, int kv, const PagedArgs& a,
                         cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_dynamic_smem(paged_split_kernel<T, D, GM>,
                                       split_smem_bytes(D, GM, sizeof(T)), smem_set);
  if (err != cudaSuccess) return err;
  paged_split_kernel<T, D, GM><<<dim3(kv, b, a.n_splits), kThreads,
                                 split_smem_bytes(D, a.group, sizeof(T)), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), part_acc, part_ml, a);
  return cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* part_acc,
           float* part_ml, int b, int kv, const PagedArgs& a, cudaStream_t stream) {
  cudaError_t err =
      a.group <= 2   ? launch_split<T, D, 2>(q, k, v, o, part_acc, part_ml, b, kv, a, stream)
      : a.group <= 8 ? launch_split<T, D, 8>(q, k, v, o, part_acc, part_ml, b, kv, a, stream)
                     : launch_split<T, D, kMaxGroup>(q, k, v, o, part_acc, part_ml, b, kv, a,
                                                     stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_splits > 1) {
    paged_combine_kernel<T, D><<<dim3(a.n_heads, b), (D + kWarp - 1) / kWarp * kWarp, 0, stream>>>(
        part_acc, part_ml, static_cast<T*>(o), a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int d, const void* q, const void* k, const void* v, void* o, float* part_acc,
                 float* part_ml, int b, int kv, const PagedArgs& a, cudaStream_t stream) {
#define REPRO_PAGED_CASE(DIM) \
  case DIM:                   \
    return launch<T, DIM>(q, k, v, o, part_acc, part_ml, b, kv, a, stream);
  switch (d) {
    REPRO_PAGED_CASE(8)
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(32)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(80)
    REPRO_PAGED_CASE(128)
    REPRO_PAGED_CASE(160)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PAGED_CASE
}

}  // namespace

// Dynamic shared memory of the split kernel for this head_dim, group size
// and dtype, in bytes.
extern "C" int paged_attention_smem_bytes(int d, int group, int dtype) {
  return static_cast<int>(split_smem_bytes(d, group, dtype == kF32 ? 4 : 2));
}

// q: (B, H, D) by its (batch, head) element strides; k_pool/v_pool:
// (NB, BS, KV, D) by their (block, slot, head) strides; every dim stride is
// 1. tables: (B, MAXB) int32 with row stride t_sb; lens: (B,) int32 on the
// device; o: (B, H, D) by its (batch, head) strides. bps: table blocks per
// split; n_splits = ceil(MAXB / bps). With n_splits > 1, part is fp32
// scratch of B * H * n_splits * (D + 2): the partials' acc (B, H, n_splits,
// D), then their (m, l) (B, H, n_splits, 2). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unbuilt head_dim or
// dtype, H % KV != 0, more than 32 query heads per kv head, or a split
// count that does not cover the table.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lens, void* o, void* part, int b, int h, int kv, int d,
    int bs, int maxb, int bps, int n_splits, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long t_sb, long long o_sb, long long o_sh, float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if (kv <= 0 || h % kv != 0 || h / kv > kMaxGroup || bs <= 0 || maxb < 0 || bps <= 0 ||
      n_splits <= 0 || n_splits > 65535 || static_cast<long long>(n_splits) * bps < maxb ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elt = dtype == kF32 ? 4 : 2, per16 = 16 / elt;
  const int vec = aligned16(k_pool) && aligned16(v_pool) && k_sb % per16 == 0 &&
                  k_ss % per16 == 0 && k_sh % per16 == 0 && v_sb % per16 == 0 &&
                  v_ss % per16 == 0 && v_sh % per16 == 0;
  const PagedArgs a{static_cast<const int*>(tables), static_cast<const int*>(lens), maxb, bs,
                    h / kv, h, bps, n_splits, vec, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                    v_sh, t_sb, o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* pm = pa == nullptr ? nullptr : pa + static_cast<size_t>(b) * h * n_splits * d;
  if (dtype == kF32) return dispatch_dim<float>(d, q, k_pool, v_pool, o, pa, pm, b, kv, a, s);
  if (dtype == kBF16)
    return dispatch_dim<__nv_bfloat16>(d, q, k_pool, v_pool, o, pa, pm, b, kv, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
