// Causal MLA prefill attention, decompressed form, for Hopper (sm_90a).
//
// Replaces no TPU kernel: repro leaves MLA's attention products to XLA
// (repro/kernels' supported_kernel_sites has no MLA site), and the port's
// plain path (models/attention.py, _mla_full) materialised a (B, H, S, S)
// score tensor per layer and passed it through about eight elementwise
// passes (two einsums and their add, a float copy, the scale, the mask, the
// softmax, a bf16 copy, a layout copy before the value product): 1 GiB a
// layer at a 4096-token prompt. This kernel computes the same function,
//   out = softmax(scale * (q_nope k_nope^T + q_rope k_rope^T), causal) v,
// with the scores kept in registers. Inputs (bf16, unit last-dim stride,
// any other strides): q_nope (B, S, H, 128), the rope'd q_rope (B, S, H, 64),
// k_nope (B, S, H, 128), the rope'd k_rope (B, S, 64) that every head shares
// (read once per key tile, never expanded to H heads), v (B, S, H, 128);
// out (B, S, H, 128) bf16. Causal by index: key k is seen by query q iff
// k <= q. Online softmax in fp32 in the log2 domain (exp2 of scores scaled
// by scale * log2 e), masked scores at the finite NEG_INF = -1e9, l floored
// at 1e-30, P rounded to bf16 for the value product (where the plain path
// rounds its softmax output); the scores themselves stay fp32, where the
// plain path rounds the einsums' sum to bf16.
//
// Bound on the H100: QK depth 192 and V width 128 over S (S + 1) / 2 causal
// pairs a head: at (B 1, S 4096, H 16) 2 * 8,390,656 * 16 * (192 + 128) =
// 85.9 GFLOP, 0.087 ms at 989 TFLOP/s, against about 76 MB of q, k, v and
// out, 0.023 ms at 3.35 TB/s: bound by operations, so both products run on
// wgmma, the tensor cores' full-rate path on Hopper.
//
// Design: a CTA owns 128 q rows of one (batch, head) and walks the 64-key
// tiles from 0 to the diagonal, with warps in two roles. One producer warp
// keeps TMA loads in flight: Q (128 x 192, 48 KB) once, then each tile's K
// (the head's k_nope beside the shared k_rope, 64 x 192) and V (64 x 128)
// into a ring of 4 stages (40 KB each), each stage guarded by a "full"
// mbarrier (the copies' bytes land) and an "empty" one (both consumers are
// done with it). TMA writes every operand in the 128-byte swizzle that
// wgmma reads (chunk c of a 128-byte row r at chunk c ^ (r % 8), operands
// cut into boxes of 64 columns) and zero-fills rows past S. Two consumer
// warpgroups of 64 q rows each, per tile: S = Q K^T by 12
// wgmma.m64n64k16 from shared memory (both operands K-major); the online
// softmax on the fp32 accumulators in registers (row max and sum across
// the quad of lanes sharing a row by two shuffles); P to bf16 in
// registers, the accumulator's layout being the register A operand's;
// O += P V by 4 wgmma.m64n128k16 with A from registers and V N-major from
// shared memory. No block-wide barrier after the start: the consumers
// meet only at the ring, so one can run its softmax while the other's
// products hold the tensor cores. Only the diagonal tile is masked; tiles
// past a warpgroup's diagonal are released unread (the first warpgroup
// skips the CTA's last tile). The grid launches the heaviest q tiles (the
// last ones) first. The host encodes one tensor map per operand from its
// strides (dims D, H, S, B innermost first): every base address and stride
// a multiple of 16 bytes, which the wrapper ensures. A barrier wait that
// outlasts about two seconds traps rather than hanging the card.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e9f;
constexpr int kDn = 128, kDr = 64, kDv = 128, kDqk = kDn + kDr;
constexpr int kRows = 128;    // q rows of a CTA: two warpgroups of 64
constexpr int kKeys = 64;     // keys of a K/V tile
constexpr int kStages = 4;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
// bytes: Q as 3 boxes of [128 rows][64]; a stage as K (3 boxes of [64
// keys][64]: k_nope 0-63, 64-127, k_rope) then V (2 boxes of [64 keys][64])
constexpr int kBlockQ = kRows * 128, kBlockK = kKeys * 128;
constexpr int kQBytes = 3 * kBlockQ;
constexpr int kVOffset = 3 * kBlockK;
constexpr int kStageBytes = kVOffset + 2 * kBlockK;
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;  // full[4], empty[4], q
constexpr size_t kSmem = kBarOffset + 8 * (2 * kStages + 1) + 1024;  // + room to align to 1 KB

struct Maps {  // TMA tensor maps of the operands
  CUtensorMap qn, qr, kn, kr, v;
};

struct Args {
  bf16* o;
  int s;
  float scale_log2;  // scale * log2(e)
  long long o_b, o_s, o_h;
};

// d (64 x 64, fp32) (+)= a (64 x 16, K-major, smem) * b (16 x 64, K-major
// smem: [keys][depth]); `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 in registers: the m16n8k16 A
// fragment of each warp's 16 rows) * b (16 x 128, N-major smem: [keys][dims])
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_prefill_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const unsigned q_s = smem_u32(smem), ring = q_s + kQBytes;
  const unsigned full = q_s + kBarOffset, empty = full + 8 * kStages, q_bar = empty + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int q0 = qt * kRows;
  // key tiles: 0 .. the second warpgroup's diagonal, cut at S
  const int n_tiles = min(q0 / kKeys + 2, (a.s + kKeys - 1) / kKeys);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, kQBytes);
      tma_load(q_s, &maps.qn, q_bar, 0, h, q0, b);
      tma_load(q_s + kBlockQ, &maps.qn, q_bar, 64, h, q0, b);
      tma_load(q_s + 2 * kBlockQ, &maps.qr, q_bar, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, k0 = j * kKeys;
        if (j >= kStages) mbar_wait(empty + 8 * st, (j / kStages + 1) & 1);
        const unsigned dst = ring + st * kStageBytes, bar = full + 8 * st;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(dst, &maps.kn, bar, 0, h, k0, b);
        tma_load(dst + kBlockK, &maps.kn, bar, 64, h, k0, b);
        tma_load(dst + 2 * kBlockK, &maps.kr, bar, 0, k0, b);
        tma_load(dst + kVOffset, &maps.v, bar, 0, h, k0, b);
        tma_load(dst + kVOffset + kBlockK, &maps.v, bar, 64, h, k0, b);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c4 = lane % 4;
  const int my_last = q0 / kKeys + wg;          // this warpgroup's diagonal tile
  const bool active = q0 + 64 * wg < a.s;       // this warpgroup holds a row of S

  float o_acc[64], s[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // rows g and g + 8
  const int row0 = q0 + 64 * wg + 16 * warp + g;                // this lane's first row
  const unsigned q_addr = q_s + wg * 64 * 128;  // this warpgroup's rows

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    if (!active || j > my_last) {
      mbar_arrive(empty + 8 * st);
      continue;
    }
    const unsigned k_addr = ring + st * kStageBytes;
    const unsigned v_addr = k_addr + kVOffset;

    // S = Q K^T over depth 192: 3 blocks of 64, 4 steps of 16 (32 bytes) each
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqk / 16; ++kk) {
      const unsigned blk = kk / 4, off = (kk % 4) * 32;
      wgmma_qk(s, smem_desc(q_addr + blk * kBlockQ + off, 0, 1024),
               smem_desc(k_addr + blk * kBlockK + off, 0, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax on the accumulators: register 4 n + v holds row
    // g + 8 (v >> 1), key 8 n + 2 c4 + (v & 1) of the tile
    const int k0 = j * kKeys;
    const bool diag = j == my_last;
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float x = s[4 * n + v] * a.scale_log2;
        if (diag && k0 + 8 * n + 2 * c4 + (v & 1) > row0 + 8 * (v >> 1)) x = kNegInf;
        s[4 * n + v] = x;
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
        s[4 * n + v] = exp2f(s[4 * n + v] - m_run[v >> 1]);
        l_run[v >> 1] += s[4 * n + v];
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16x2(s[4 * n], s[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(s[4 * n + 2], s[4 * n + 3]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: 4 steps of 16 keys; V's two 64-dim blocks 8 KB apart, 16
    // keys 2 KB apart
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_pv(o_acc, pa[kk], smem_desc(v_addr + 2048 * kk, kBlockK, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    mbar_arrive(empty + 8 * st);  // this thread's reads of the stage are done
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.s) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* op = a.o + b * a.o_b + h * a.o_h + static_cast<long long>(qi) * a.o_s;
#pragma unroll
    for (int n = 0; n < kDv / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + 2 * c4) =
          __floats2bfloat162_rn(o_acc[4 * n + 2 * r] * inv, o_acc[4 * n + 2 * r + 1] * inv);
  }
}

}  // namespace

// Dynamic shared memory of the kernel, in bytes.
extern "C" int mla_prefill_smem_bytes() { return static_cast<int>(kSmem); }

// q_nope (B, S, H, 128), q_rope (B, S, H, 64), k_nope (B, S, H, 128), k_rope
// (B, S, 64), v (B, S, H, 128), out (B, S, H, 128), all bf16, each given by
// its element strides (batch, seq, head; k_rope batch, seq) with a unit
// last-dim stride; every input's base and strides multiples of 16 bytes,
// out's strides even. Returns cudaGetLastError(), cudaErrorInvalidValue
// for arguments it does not take, or kEncodeError + the CUresult of
// cuTensorMapEncodeTiled where a tensor map cannot be encoded.
extern "C" int mla_prefill_launch(const void* q_nope, const void* q_rope, const void* k_nope,
                                  const void* k_rope, const void* v, void* out, int b, int s,
                                  int h, long long qn_b, long long qn_s, long long qn_h,
                                  long long qr_b, long long qr_s, long long qr_h, long long kn_b,
                                  long long kn_s, long long kn_h, long long kr_b, long long kr_s,
                                  long long v_b, long long v_s, long long v_h, long long o_b,
                                  long long o_s, long long o_h, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const int n_q = (s + kRows - 1) / kRows;
  if (b > 65535 || n_q > 65535 || o_b % 2 || o_s % 2 || o_h % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_dynamic_smem(mla_prefill_kernel, kSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps;
  const long long qn_dims[4] = {kDn, h, s, b}, qn_str[3] = {qn_h, qn_s, qn_b};
  const long long qr_dims[4] = {kDr, h, s, b}, qr_str[3] = {qr_h, qr_s, qr_b};
  const long long kn_dims[4] = {kDn, h, s, b}, kn_str[3] = {kn_h, kn_s, kn_b};
  const long long kr_dims[3] = {kDr, s, b}, kr_str[2] = {kr_s, kr_b};
  const long long v_dims[4] = {kDv, h, s, b}, v_str[3] = {v_h, v_s, v_b};
  const CUresult res[5] = {encode(fn, &maps.qn, q_nope, 4, qn_dims, qn_str, 2, kRows),
                           encode(fn, &maps.qr, q_rope, 4, qr_dims, qr_str, 2, kRows),
                           encode(fn, &maps.kn, k_nope, 4, kn_dims, kn_str, 2, kKeys),
                           encode(fn, &maps.kr, k_rope, 3, kr_dims, kr_str, 1, kKeys),
                           encode(fn, &maps.v, v, 4, v_dims, v_str, 2, kKeys)};
  for (CUresult r : res)
    if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  const Args args{static_cast<bf16*>(out), s, scale * kLog2e, o_b, o_s, o_h};
  mla_prefill_kernel<<<dim3(h, b, n_q), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, args);
  return static_cast<int>(cudaGetLastError());
}
