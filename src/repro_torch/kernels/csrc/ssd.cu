// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py (ssd / _ssd_kernel).
// Same contract: x (B, S, H, P) in fp32 or bf16, dt (B, S, H) fp32, a (H,)
// fp32, B and C (B, S, G, N) in x's dtype, head h reading group h / (H / G),
// S a multiple of the chunk Q, zero initial state. Out: y (B, S, H, P) fp32
// and the final state (B, H, P, N) fp32, both contiguous. Per chunk, with
// cs the chunk's cumsum of dt * a and xdt = x * dt:
//   y[t]   = sum_{s <= t} (C_t . B_s) exp(cs_t - cs_s) xdt[s]      (within)
//          + exp(cs_t) C_t . state^T                              (entering)
//   state' = state exp(cs_last) + sum_s (xdt[s] exp(cs_last - cs_s))^T B_s
// Decays are exp of differences of cumsums, never products of exps, and the
// masked (s > t) entries are exp(-1e9) = 0, as in Pallas.
//
// Bound on the H100: at mamba2-2.7b's 512-token prefill (x (1, 512, 80, 64)
// bf16, N 128, Q 256) a call must move about 18.8 MB (x, dt, B, C in; y and
// the final state out, both fp32), 5.6 us at 3.35 TB/s, against about 5 GFLOP
// of products, 5 us at the bf16 tensor rate: bound by bytes, by a little.
// Filling the card is the first problem: one CTA per (batch, head) is 80
// CTAs on 132 SMs at batch 1.
//
// Design, bf16: one call, three kernels (the decomposition of Mamba2's own
// GPU kernels, arXiv:2405.21060 section 6), joined through one scratch the
// wrapper allocates (per (batch, head, chunk) the entering state as bf16 hi
// and lo, the chunk's own fp32 contribution, and its total of dt * a).
// Passes (a) and (c) each recompute the chunk's cumsum of dt * a with the
// same code, so both read the same cs: every thread loads some of the
// chunk's dt (all loads in flight at once), then warp 0 scans them (a run
// per lane, then a shuffle scan); there is no cumsum pass.
//  (a) ssd_chunk_state_kernel, grid (N / 64 column tiles, chunks, B * H):
//      the chunk's own contribution (xdt exp(cs_last - cs))^T B, a (P, 64)
//      tile; 4 warps of 16 rows of P, 32 fp32 accumulators a thread. The
//      chunk's positions come in tiles of 64: B by cp.async; x through
//      registers (the next tile's loads issued before this tile's
//      products), scaled by dt exp(cs_last - cs) and split into bf16 hi +
//      lo. The first tile's loads fly while the cumsum is taken. Writes the
//      contribution and cs_last.
//  (b) ssd_state_pass_kernel, grid (P * N / 256, B * H): per element, the
//      state entering each chunk, state_c = state_{c-1} exp(cs_last_{c-1}) +
//      contrib_{c-1}, written as bf16 hi + lo (the form pass (c) multiplies
//      with, so pass (c) copies it by cp.async); its last value is the
//      final state, in fp32. Sequential over chunks, elementwise over P x N.
//  (c) ssd_chunk_scan_kernel, grid (B * H, chunks, Q / 64 row tiles), the
//      heaviest row tiles first (640 CTAs at mamba2's prefill, where one
//      CTA per (batch, head) makes 80): y of 64 rows. The rows' C and the entering
//      state are staged once by cp.async, C's fragments kept in registers;
//      the entering state's term exp(cs_t) C . state^T comes first, then for
//      each 64-column tile up to the diagonal (B and x through a two-stage
//      cp.async ring, staged once for all four warps) S = C B^T, decayed
//      (exp2 of the scaled difference of cumsums; one exp per score is
//      most of this pass's own time), masked on the diagonal tile and
//      times dt in registers, then y += S x.
// Products on mma.sync.m16n8k16 with fp32 accumulators. C . B^T has bf16
// operands: their products are exact in fp32, only the order of sums
// changes. Every product with an fp32 operand (the decayed scores, the
// scaled x of the contribution, the state) takes it as bf16 hi + lo (within
// 2^-16 of it) against an exact bf16 operand (x, B or C): two products, so
// no fp32 operand is rounded to a single bf16. Rows are padded by 16 bytes
// (ldmatrix reads without bank conflicts); P, N and positions past the
// chunk are zero-padded in shared memory. Where x, B or C rows are not
// 16-byte chunks they are staged by scalar loads. No atomics: repeated
// calls give the same bits.
//
// Design, float32 (ssd_kernel, which the float32 parity checks rest on):
// one CTA of 256 threads owns one (batch, head) and walks the
// chunks in a loop, with the (P, N) fp32 state in shared memory; a chunk's y
// is made in row tiles of 64 (the tile's C rows staged once; per 64-column
// tile up to the tile's last row, B and xdt staged, scores C_rows . B^T
// formed, masked and decayed in shared memory, scores . xdt added to a
// register accumulator), then the entering-state term; after all row tiles
// the state update, each thread owning (P/16) x (N/16) entries in
// registers. Warp 0 scans dt * a for the chunk's cumsum. fp32 FMAs on the
// CUDA cores.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 256;
constexpr int kTile = 64;                   // rows and columns of a score tile
constexpr int kTx = 16;                     // thread grid 16 x 16
constexpr int kRows = kTile / (kThreads / kTx);  // 4 tile rows per thread
constexpr int kMaxSmem = 232448;            // bytes a block may use on sm_90

struct Strides {
  long long b, s, h;  // element strides of batch, sequence and head (or group)
};

// Shared-memory floats for the given shapes.
long long smem_floats(int p, int n, int q) {
  return static_cast<long long>(p) * (n + 1) + 2LL * q + 2LL * kTile * (n + 1) +
         static_cast<long long>(kTile) * (p + 1) + static_cast<long long>(kTile) * (kTile + 1);
}

// P <= 16 * PJ and N <= 16 * NJ: the register tiles of one thread.
template <int PJ, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ y,
           float* __restrict__ fin, int s_len, int h_count, int p, int rep, int n, int q,
           Strides xs, Strides ds, Strides bs, Strides cs) {
  extern __shared__ float smem[];
  const int np = n + 1, pp = p + 1, sp = kTile + 1;
  float* st = smem;             // (P, N+1)      carried state
  float* dts = st + p * np;     // (Q)           dt of the chunk
  float* cum = dts + q;         // (Q)           cumsum of dt * a within the chunk
  float* ct = cum + q;          // (64, N+1)     C rows of the row tile
  float* bt = ct + kTile * np;  // (64, N+1)     B rows of the column tile
  float* xt = bt + kTile * np;  // (64, P+1)     xdt (times the decay, in the state pass)
  float* sc = xt + kTile * pp;  // (64, 64+1)    masked, decayed scores

  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int hh = blockIdx.x, b = blockIdx.y, g = hh / rep;
  const float a_h = a[hh];
  const float* xb = x + b * xs.b + hh * xs.h;
  const float* db = dt + b * ds.b + hh * ds.h;
  const float* bb = bm + b * bs.b + g * bs.h;
  const float* cb = cm + b * cs.b + g * cs.h;
  const long long y_ss = static_cast<long long>(h_count) * p;
  float* yb = y + static_cast<long long>(b) * s_len * y_ss + static_cast<long long>(hh) * p;
  float* fb = fin + (static_cast<long long>(b) * h_count + hh) * p * n;

  for (int i = tid; i < p * np; i += kThreads) st[i] = 0.f;

  for (int c0 = 0; c0 < s_len; c0 += q) {
    // --- dt of the chunk, and the cumsum of dt * a (warp 0: a run per lane,
    // then a scan of the lane totals)
    __syncthreads();  // the previous chunk is done with dts and cum
    for (int i = tid; i < q; i += kThreads) dts[i] = db[(c0 + i) * ds.s];
    __syncthreads();
    if (tid < 32) {
      const int per = (q + 31) / 32;
      const int lo = min(q, tid * per), hi = min(q, lo + per);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) run += dts[i] * a_h;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float acc = incl - run;
      for (int i = lo; i < hi; ++i) {
        acc += dts[i] * a_h;
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float cs_last = cum[q - 1];

    // --- y, one row tile of 64 chunk positions at a time
    for (int r0 = 0; r0 < q; r0 += kTile) {
      const int rows = min(kTile, q - r0);
      __syncthreads();  // the previous row tile is done with ct
      for (int i = tid; i < kTile * n; i += kThreads) {
        const int r = i / n, k = i - r * n;
        ct[r * np + k] = r < rows ? cb[(c0 + r0 + r) * cs.s + k] : 0.f;
      }
      float acc[kRows][PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < r0 + rows; k0 += kTile) {  // columns up to the tile's last row
        const int cols = min(kTile, q - k0);
        __syncthreads();  // done with the previous bt, xt, sc
        for (int i = tid; i < kTile * n; i += kThreads) {
          const int r = i / n, k = i - r * n;
          bt[r * np + k] = r < cols ? bb[(c0 + k0 + r) * bs.s + k] : 0.f;
        }
        for (int i = tid; i < kTile * p; i += kThreads) {
          const int r = i / p, k = i - r * p;
          xt[r * pp + k] = r < cols ? xb[(c0 + k0 + r) * xs.s + k] * dts[k0 + r] : 0.f;
        }
        __syncthreads();
        // scores of rows ty*4 + i against columns tx + 16*j
        float s4[kRows][4];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s4[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cv[kRows], bv[4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) cv[i] = ct[(ty * kRows + i) * np + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt[(tx + kTx * j) * np + k];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s4[i][j] = fmaf(cv[i], bv[j], s4[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int t = r0 + ty * kRows + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = k0 + tx + kTx * j;
            float ell = 0.f;
            if (t < q && u < q) ell = expf(t >= u ? cum[t] - cum[u] : kNegInf);
            sc[(ty * kRows + i) * sp + tx + kTx * j] = s4[i][j] * ell;
          }
        }
        __syncthreads();
        // acc += scores . xdt
        for (int u = 0; u < cols; ++u) {
          float sv[kRows], xv[PJ];
#pragma unroll
          for (int i = 0; i < kRows; ++i) sv[i] = sc[(ty * kRows + i) * sp + u];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xt[u * pp + min(tx + kTx * j, p - 1)];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }
      // the entering state's term: exp(cs_t) * C_t . state^T
      float off[kRows][PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) off[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[kRows], sv[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i) cv[i] = ct[(ty * kRows + i) * np + k];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = st[min(tx + kTx * j, p - 1) * np + k];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
        if (r >= rows) continue;
        const float e = expf(cum[r0 + r]);
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int pc = tx + kTx * j;
          if (pc < p) yb[(c0 + r0 + r) * y_ss + pc] = acc[i][j] + e * off[i][j];
        }
      }
    }

    // --- the state update, after every row tile has read the entering state
    float sacc[PJ][NJ];
    const float chunk_decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pr = ty + kTx * i, nc = tx + kTx * j;
        sacc[i][j] = (pr < p && nc < n) ? st[pr * np + nc] * chunk_decay : 0.f;
      }
    for (int k0 = 0; k0 < q; k0 += kTile) {
      const int cols = min(kTile, q - k0);
      __syncthreads();  // done with bt, xt (and, the first time, with st and ct)
      for (int i = tid; i < kTile * n; i += kThreads) {
        const int r = i / n, k = i - r * n;
        bt[r * np + k] = r < cols ? bb[(c0 + k0 + r) * bs.s + k] : 0.f;
      }
      for (int i = tid; i < kTile * p; i += kThreads) {
        const int r = i / p, k = i - r * p;
        xt[r * pp + k] = r < cols ? xb[(c0 + k0 + r) * xs.s + k] * dts[k0 + r] *
                                        expf(cs_last - cum[k0 + r])
                                  : 0.f;
      }
      __syncthreads();
      for (int u = 0; u < cols; ++u) {
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = xt[u * pp + min(ty + kTx * i, p - 1)];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = bt[u * np + min(tx + kTx * j, n - 1)];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    const bool last = c0 + q >= s_len;
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pr = ty + kTx * i, nc = tx + kTx * j;
        if (pr < p && nc < n) {
          st[pr * np + nc] = sacc[i][j];  // each thread rewrites only its own entries
          if (last) fb[pr * n + nc] = sacc[i][j];
        }
      }
  }
}

template <int PJ, int NJ>
int launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
           float* y, float* fin, int bsz, int s, int h, int p, int g, int n, int q,
           Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p, n, q);
  auto kernel = ssd_kernel<PJ, NJ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(h, bsz), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(bm),
      static_cast<const float*>(cm), y, fin, s, h, p, h / g, n, q, xs, ds, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

template <int PJ>
int dispatch_n(int n, const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, float* y, float* fin, int bsz, int s, int h, int p, int g,
               int q, Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t st) {
  if (n <= 16) return launch<PJ, 1>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  if (n <= 32) return launch<PJ, 2>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  if (n <= 64) return launch<PJ, 4>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  if (n <= 128) return launch<PJ, 8>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_p(int p, int n, const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, float* y, float* fin, int bsz, int s, int h, int g, int q,
               Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t st) {
  if (p <= 16) return dispatch_n<1>(n, x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, q, xs, ds, bs, cs, st);
  if (p <= 32) return dispatch_n<2>(n, x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, q, xs, ds, bs, cs, st);
  if (p <= 64) return dispatch_n<4>(n, x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, q, xs, ds, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// bfloat16: three passes on the tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcRows = 64;      // positions of a tile

struct TcArgs {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* bm;
  const bf16* cm;
  float* y;
  float* fin;
  bf16* entering;   // (B * H, chunks, 2, P, N): the state entering each chunk as hi, lo (b)
  float* contrib;   // (B * H, chunks, P, N): each chunk's own contribution (a)
  float* chunk_cs;  // (B * H, chunks): each chunk's total of dt * a (a)
  int s_len, h_count, p, rep, n, q, n_chunks;
  int vec;          // x, B and C rows are whole, aligned 16-byte chunks
  Strides xs, ds, bs, cs;
};

// Shared-memory bytes of the chunk's dt and cumsum (two fp32 arrays of q),
// rounded up so that the bf16 tiles after them are 16-byte aligned; of pass
// (a) (PP padded P, NC its column tile) and of pass (c) (NP padded N).
__host__ __device__ constexpr size_t scan_bytes(int q) { return (8 * static_cast<size_t>(q) + 15) / 16 * 16; }
constexpr size_t state_smem(int pp, int nc, int q) {
  return scan_bytes(q) + sizeof(bf16) * kTcRows * (2 * (pp + 8) + (nc + 8));
}
constexpr size_t scan_smem(int pp, int np, int q) {
  return scan_bytes(q) + sizeof(bf16) * (kTcRows * (np + 8) + 2 * kTcRows * ((np + 8) + (pp + 8)) +
                                         2 * pp * (np + 8));
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Every thread: dts[i] = dt of chunk position i (all loads in flight at once).
__device__ __forceinline__ void load_dt(const float* db, long long ds_s, int q, float* dts) {
  for (int i = threadIdx.x; i < q; i += kTcThreads) dts[i] = db[i * ds_s];
}

// Warp 0, after load_dt and a barrier: cum[i] = the inclusive cumsum of
// dts * a_h (a run per lane, then a shuffle scan of the lane totals).
__device__ __forceinline__ void chunk_cumsum(float a_h, int q, const float* dts, float* cum,
                                             int lane) {
  const int per = (q + 31) / 32;
  const int lo = min(q, lane * per), hi = min(q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run += dts[i] * a_h;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float acc = incl - run;
  for (int i = lo; i < hi; ++i) {
    acc += dts[i] * a_h;
    cum[i] = acc;
  }
}

// Zero columns [w, W) of `rows` rows of row stride RS (the padding no copy writes).
template <int RS>
__device__ __forceinline__ void zero_cols(bf16* t, int rows, int w, int W) {
  if (w >= W) return;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < rows * (W - w); i += kTcThreads)
    t[(i / (W - w)) * RS + w + i % (W - w)] = zero;
}

// (a) the chunk's own contribution to the state: contrib[p][n0 + j] =
// sum_s x[s][p] dt[s] exp(cs_last - cs[s]) B[s][n0 + j]. PP, NP: P and N
// padded to 16; NC = min(64, NP) columns a CTA.
template <int PP, int NP>
__global__ void __launch_bounds__(kTcThreads) ssd_chunk_state_kernel(TcArgs a) {
  constexpr int NC = NP < 64 ? NP : 64;
  constexpr int XS = PP + 8, BS = NC + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dts = reinterpret_cast<float*>(smem_raw);                  // (Q) dt, then dt exp(cs_last - cs)
  float* cum = dts + a.q;                                           // (Q)
  bf16* x_hi = reinterpret_cast<bf16*>(smem_raw + scan_bytes(a.q));  // [64][XS]
  bf16* x_lo = x_hi + kTcRows * XS;                                 // [64][XS]
  bf16* b_t = x_lo + kTcRows * XS;                                  // [64][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c4 = lane & 3;
  const int n0 = blockIdx.x * NC, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.h_count, hh = bh % a.h_count, g = hh / a.rep;
  const long long c0 = static_cast<long long>(c) * a.q;
  const bf16* xb = a.x + b * a.xs.b + c0 * a.xs.s + hh * a.xs.h;
  const bf16* bb = a.bm + b * a.bs.b + c0 * a.bs.s + g * a.bs.h + n0;
  const float* db = a.dt + b * a.ds.b + c0 * a.ds.s + hh * a.ds.h;
  const int ncols = min(NC, a.n - n0);
  const bool vec = a.vec != 0;

  // x rows of the tile at s0 into registers, a thread's loads issued together
  constexpr int XI = kTcRows * (PP / 8) / kTcThreads;  // 16-byte chunks a thread
  static_assert(kTcRows * (PP / 8) % kTcThreads == 0, "x chunks divide among the threads");
  auto load_x = [&](int s0, uint4 (&raw)[XI]) {
#pragma unroll
    for (int it = 0; it < XI; ++it) {
      const int i = tid + it * kTcThreads, r = i / (PP / 8), col = (i % (PP / 8)) * 8;
      const bf16* src = xb + static_cast<long long>(s0 + r) * a.xs.s + col;
      bf16* e = reinterpret_cast<bf16*>(&raw[it]);
      if (s0 + r < a.q && vec && col < a.p) {
        raw[it] = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = s0 + r < a.q && col + k < a.p ? src[k] : __float2bfloat16(0.f);
      }
    }
  };

  // the first tile's B and x are in flight while the cumsum is taken
  zero_cols<BS>(b_t, kTcRows, ncols, NC);
  stage_rows<BS, kTcThreads>(b_t, bb, a.bs.s, 0, a.q, ncols, vec, kTcRows);
  cp_async_commit();
  uint4 raw[XI], next[XI];
  load_x(0, raw);
  load_dt(db, a.ds.s, a.q, dts);
  __syncthreads();
  if (warp == 0) chunk_cumsum(a.a[hh], a.q, dts, cum, lane);
  __syncthreads();
  const float cs_last = cum[a.q - 1];
  for (int i = tid; i < a.q; i += kTcThreads) dts[i] *= expf(cs_last - cum[i]);
  if (blockIdx.x == 0 && tid == 0) a.chunk_cs[static_cast<long long>(bh) * a.n_chunks + c] = cs_last;
  __syncthreads();  // the weights in dts are written

  float acc[NC / 8][4];
#pragma unroll
  for (int i = 0; i < NC / 8; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;

  for (int s0 = 0; s0 < a.q; s0 += kTcRows) {
    if (s0 > 0) {
      __syncthreads();  // the previous tile is read
      stage_rows<BS, kTcThreads>(b_t, bb, a.bs.s, s0, a.q, ncols, vec, kTcRows);
      cp_async_commit();
    }
    // x times the weight, split into hi + lo; the next tile's x loads go out
    // before this tile's products
#pragma unroll
    for (int it = 0; it < XI; ++it) {
      const int i = tid + it * kTcThreads, r = i / (PP / 8), col = (i % (PP / 8)) * 8;
      const float w = s0 + r < a.q ? dts[s0 + r] : 0.f;
      const bf16* e = reinterpret_cast<const bf16*>(&raw[it]);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        split_bf16(__bfloat162float(e[k]) * w, x_hi[r * XS + col + k], x_lo[r * XS + col + k]);
    }
    if (s0 + kTcRows < a.q) load_x(s0 + kTcRows, next);
    cp_async_wait<0>();
    __syncthreads();
    if (warp * 16 < PP) {
#pragma unroll
      for (int ks = 0; ks < kTcRows / 16; ++ks) {
        unsigned ahi[4], alo[4];  // x^T (rows of P x 16 positions), read transposed
        const int off = (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * XS + warp * 16 +
                        ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(ahi, x_hi + off);
        ldmatrix_x4_trans(alo, x_lo + off);
#pragma unroll
        for (int n2 = 0; n2 < NC / 16; ++n2) {
          unsigned bf[4];  // B (16 positions x 16 columns), read transposed
          ldmatrix_x4_trans(bf, b_t + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                                    16 * n2 + (lane >> 4) * 8);
          mma_bf16(acc[2 * n2], ahi, bf[0], bf[1]);
          mma_bf16(acc[2 * n2], alo, bf[0], bf[1]);
          mma_bf16(acc[2 * n2 + 1], ahi, bf[2], bf[3]);
          mma_bf16(acc[2 * n2 + 1], alo, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < XI; ++it) raw[it] = next[it];
  }

  if (warp * 16 < PP) {
    float* out = a.contrib + (static_cast<long long>(bh) * a.n_chunks + c) * a.p * a.n + n0;
#pragma unroll
    for (int i = 0; i < NC / 8; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pr = warp * 16 + gq + 8 * (v >> 1), nc = 8 * i + 2 * c4 + (v & 1);
        if (pr < a.p && nc < ncols) out[static_cast<long long>(pr) * a.n + nc] = acc[i][v];
      }
  }
}

// (b) the state entering each chunk after the first, as bf16 hi + lo, and
// the final state; the next chunk's contribution is loaded before this
// chunk's state is stored.
__global__ void __launch_bounds__(256) ssd_state_pass_kernel(TcArgs a) {
  const int e = blockIdx.x * 256 + threadIdx.x, bh = blockIdx.y;
  const int pn = a.p * a.n;
  if (e >= pn) return;
  const long long r0 = static_cast<long long>(bh) * a.n_chunks;
  const float* contrib = a.contrib + r0 * pn + e;
  bf16* entering = a.entering + r0 * 2 * pn + e;
  float st = 0.f, next = contrib[0];
  for (int c = 0; c < a.n_chunks; ++c) {
    const float cur = next;
    if (c + 1 < a.n_chunks) next = contrib[static_cast<long long>(c + 1) * pn];
    if (c > 0) split_bf16(st, entering[2LL * c * pn], entering[2LL * c * pn + pn]);
    st = st * expf(a.chunk_cs[r0 + c]) + cur;
  }
  a.fin[static_cast<long long>(bh) * pn + e] = st;
}

// (c) y of 64 rows of one chunk: the entering state's term, then the
// within-chunk term over the column tiles up to the diagonal.
template <int PP, int NP>
__global__ void __launch_bounds__(kTcThreads) ssd_chunk_scan_kernel(TcArgs a) {
  constexpr int CS = NP + 8, XS = PP + 8;
  constexpr int KN = NP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dts = reinterpret_cast<float*>(smem_raw);  // (Q)
  float* cum = dts + a.q;                           // (Q)
  bf16* c_t = reinterpret_cast<bf16*>(smem_raw + scan_bytes(a.q));  // [64][CS]
  bf16* ring = c_t + kTcRows * CS;  // 2 x ([64][CS] B, [64][XS] x)
  constexpr int kStage = kTcRows * (CS + XS);
  bf16* st_hi = ring + 2 * kStage;  // [PP][CS]
  bf16* st_lo = st_hi + PP * CS;    // [PP][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int rt = gridDim.z - 1 - blockIdx.z;  // heaviest row tiles first
  const int r0 = rt * kTcRows;
  const int b = bh / a.h_count, hh = bh % a.h_count, g = hh / a.rep;
  const long long c0 = static_cast<long long>(c) * a.q;
  const bf16* xb = a.x + b * a.xs.b + c0 * a.xs.s + hh * a.xs.h;
  const bf16* bb = a.bm + b * a.bs.b + c0 * a.bs.s + g * a.bs.h;
  const bf16* cb = a.cm + b * a.cs.b + c0 * a.cs.s + g * a.cs.h;
  const float* db = a.dt + b * a.ds.b + c0 * a.ds.s + hh * a.ds.h;
  const bool vec = a.vec != 0;

  zero_cols<CS>(c_t, kTcRows, a.n, NP);
  for (int st = 0; st < 2; ++st) {
    zero_cols<CS>(ring + st * kStage, kTcRows, a.n, NP);
    zero_cols<XS>(ring + st * kStage + kTcRows * CS, kTcRows, a.p, PP);
  }
  auto load_cols = [&](int j, int st) {  // column tile j: B and x rows [64 j, 64 j + 64)
    bf16* b_s = ring + st * kStage;
    stage_rows<CS, kTcThreads>(b_s, bb, a.bs.s, j * kTcRows, a.q, a.n, vec, kTcRows);
    stage_rows<XS, kTcThreads>(b_s + kTcRows * CS, xb, a.xs.s, j * kTcRows, a.q, a.p, vec,
                               kTcRows);
  };
  stage_rows<CS, kTcThreads>(c_t, cb, a.cs.s, r0, a.q, a.n, vec, kTcRows);
  load_cols(0, 0);
  if (c > 0) {  // the entering state, bf16 hi + lo ((P, N) each; rows past P zero)
    const bf16* sp = a.entering + (static_cast<long long>(bh) * a.n_chunks + c) * 2 * a.p * a.n;
    zero_cols<CS>(st_hi, PP, a.n, NP);
    zero_cols<CS>(st_lo, PP, a.n, NP);
    stage_rows<CS, kTcThreads>(st_hi, sp, a.n, 0, a.p, a.n, vec, PP);
    stage_rows<CS, kTcThreads>(st_lo, sp + a.p * a.n, a.n, 0, a.p, a.n, vec, PP);
  }
  cp_async_commit();
  load_dt(db, a.ds.s, a.q, dts);
  __syncthreads();
  if (warp == 0) chunk_cumsum(a.a[hh], a.q, dts, cum, lane);

  const int row_lo = r0 + warp * 16 + gq;  // this lane's rows: row_lo and row_lo + 8
  float acc[PP / 8][4];
#pragma unroll
  for (int i = 0; i < PP / 8; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
  unsigned cf[KN][4];

  const int n_cols = rt + 1;
  float cum_t[2];  // cs of this lane's rows (read after the first barrier of the loop)
  for (int j = 0; j < n_cols; ++j) {
    if (j + 1 < n_cols) load_cols(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // column tile j (and C) landed
    __syncthreads();
    if (j == 0) {
      cum_t[0] = cum[min(row_lo, a.q - 1)];
      cum_t[1] = cum[min(row_lo + 8, a.q - 1)];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldmatrix_x4(cf[kk], c_t + (warp * 16 + (lane & 15)) * CS + 16 * kk + (lane >> 4) * 8);
      if (c > 0) {  // exp(cs_t) C_t . state^T, hi and lo
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
#pragma unroll
          for (int p2 = 0; p2 < PP / 16; ++p2) {
            const int off = (16 * p2 + (lane & 7) + ((lane >> 4) << 3)) * CS + 16 * kk +
                            ((lane >> 3) & 1) * 8;
            unsigned sf[4];
            ldmatrix_x4(sf, st_hi + off);
            mma_bf16(acc[2 * p2], cf[kk], sf[0], sf[1]);
            mma_bf16(acc[2 * p2 + 1], cf[kk], sf[2], sf[3]);
            ldmatrix_x4(sf, st_lo + off);
            mma_bf16(acc[2 * p2], cf[kk], sf[0], sf[1]);
            mma_bf16(acc[2 * p2 + 1], cf[kk], sf[2], sf[3]);
          }
        const float e0 = expf(cum_t[0]), e1 = expf(cum_t[1]);
#pragma unroll
        for (int i = 0; i < PP / 8; ++i) {
          acc[i][0] *= e0;
          acc[i][1] *= e0;
          acc[i][2] *= e1;
          acc[i][3] *= e1;
        }
      }
    }
    const bf16* b_s = ring + (j & 1) * kStage;
    const bf16* x_s = b_s + kTcRows * CS;

    // S = C B^T: 16 rows x 64 columns a warp
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) s[i][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        unsigned bf[4];
        ldmatrix_x4(bf, b_s + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) * CS + 16 * kk +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], cf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * n2 + 1], cf[kk], bf[2], bf[3]);
      }
    // decayed (exp2 of the scaled difference of cumsums), masked (u <= t, on
    // the diagonal tile only: below it every u < t) and times dt[u]; as bf16
    // hi + lo A fragments
    const bool diag = j == rt;
    unsigned phi[4][4], plo[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bf16 hv[4], lv[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // this lane's two columns of n-tile i
        const int u = j * kTcRows + 8 * i + 2 * c4 + e, uc = min(u, a.q - 1);
        const float cu = cum[uc], du = dts[uc];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = row_lo + 8 * r, v = 2 * r + e;
          float val = s[i][v] * exp2f((cum_t[r] - cu) * kLog2e) * du;
          if (diag && !(u <= t && t < a.q)) val = 0.f;
          split_bf16(val, hv[v], lv[v]);
        }
      }
      phi[i >> 1][(i & 1) * 2] = pack_bf16(hv[0], hv[1]);
      phi[i >> 1][(i & 1) * 2 + 1] = pack_bf16(hv[2], hv[3]);
      plo[i >> 1][(i & 1) * 2] = pack_bf16(lv[0], lv[1]);
      plo[i >> 1][(i & 1) * 2 + 1] = pack_bf16(lv[2], lv[3]);
    }
    // y += S x: x (positions x P) as the B operand, read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p2 = 0; p2 < PP / 16; ++p2) {
        unsigned xf[4];
        ldmatrix_x4_trans(xf, x_s + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                                  16 * p2 + (lane >> 4) * 8);
        mma_bf16(acc[2 * p2], phi[kk], xf[0], xf[1]);
        mma_bf16(acc[2 * p2], plo[kk], xf[0], xf[1]);
        mma_bf16(acc[2 * p2 + 1], phi[kk], xf[2], xf[3]);
        mma_bf16(acc[2 * p2 + 1], plo[kk], xf[2], xf[3]);
      }
    __syncthreads();  // stage j & 1 is free for column tile j + 2
  }
  cp_async_wait<0>();

  const long long y_ss = static_cast<long long>(a.h_count) * a.p;
  float* yb = a.y + (static_cast<long long>(b) * a.s_len + c0) * y_ss + static_cast<long long>(hh) * a.p;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row_lo + 8 * r;
    if (t >= a.q) continue;
    float* yr = yb + t * y_ss;
#pragma unroll
    for (int i = 0; i < PP / 8; ++i) {
      const int pc = 8 * i + 2 * c4;
      if (a.p % 2 == 0) {
        if (pc < a.p) *reinterpret_cast<float2*>(yr + pc) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
      } else {
        if (pc < a.p) yr[pc] = acc[i][2 * r];
        if (pc + 1 < a.p) yr[pc + 1] = acc[i][2 * r + 1];
      }
    }
  }
}

size_t tc_smem(int pp, int np, int q) {
  const size_t s_a = state_smem(pp, np < 64 ? np : 64, q), s_c = scan_smem(pp, np, q);
  return s_a > s_c ? s_a : s_c;
}

template <int PP, int NP>
int launch_tc(const TcArgs& args, int bsz, cudaStream_t stream) {
  constexpr int NC = NP < 64 ? NP : 64;
  static bool set_a[kMaxDevices], set_c[kMaxDevices];
  cudaError_t err = allow_dynamic_smem(ssd_chunk_state_kernel<PP, NP>, kMaxSmem, set_a);
  if (err == cudaSuccess) err = allow_dynamic_smem(ssd_chunk_scan_kernel<PP, NP>, kMaxSmem, set_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bh = bsz * args.h_count;
  ssd_chunk_state_kernel<PP, NP><<<dim3(NP / NC, args.n_chunks, bh), kTcThreads,
                                   state_smem(PP, NC, args.q), stream>>>(args);
  ssd_state_pass_kernel<<<dim3((args.p * args.n + 255) / 256, bh), 256, 0, stream>>>(args);
  ssd_chunk_scan_kernel<PP, NP><<<dim3(bh, args.n_chunks, (args.q + kTcRows - 1) / kTcRows),
                                  kTcThreads, scan_smem(PP, NP, args.q), stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// P and N padded to the widths the kernels are built for (P <= 64, N <= 128)
int pp_of(int p) { return p <= 16 ? 16 : p <= 32 ? 32 : 64; }
int np_of(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <int PP>
int dispatch_tc_n(const TcArgs& args, int bsz, cudaStream_t st) {
  switch (np_of(args.n)) {
    case 16: return launch_tc<PP, 16>(args, bsz, st);
    case 32: return launch_tc<PP, 32>(args, bsz, st);
    case 64: return launch_tc<PP, 64>(args, bsz, st);
    default: return launch_tc<PP, 128>(args, bsz, st);
  }
}

int dispatch_tc(const TcArgs& args, int bsz, cudaStream_t st) {
  switch (pp_of(args.p)) {
    case 16: return dispatch_tc_n<16>(args, bsz, st);
    case 32: return dispatch_tc_n<32>(args, bsz, st);
    default: return dispatch_tc_n<64>(args, bsz, st);
  }
}

}  // namespace

// Shared-memory bytes the kernel needs at these shapes and dtype (for bf16
// the larger of passes (a) and (c)), saturated at INT_MAX (the wrapper
// checks them against ssd_smem_limit() before it launches).
extern "C" int ssd_smem_bytes(int p, int n, int q, int dtype) {
  const long long bytes =
      dtype == kBF16 ? static_cast<long long>(tc_smem(pp_of(p), np_of(n), q))
                     : static_cast<long long>(sizeof(float)) * smem_floats(p, n, q);
  return bytes > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(bytes);
}

extern "C" int ssd_smem_limit() { return kMaxSmem; }

// x (B, S, H, P) and b/c (B, S, G, N) in `dtype`, dt (B, S, H) fp32, each
// given by its (batch, seq, head-or-group) element strides with a unit last
// stride; a (H,) fp32; y (B, S, H, P) and fin (B, H, P, N) fp32, contiguous.
// For bf16, scratch is fp32 of B * H * (S / chunk) * (2 * P * N + 1): the
// states entering the chunks as bf16 hi and lo (the room of B * H *
// (S / chunk) * P * N floats), every chunk's own contribution (as many
// floats), then the chunks' totals of dt * a (unused for fp32).
// Needs S % chunk == 0, H % G == 0, P <= 64, N <= 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes or a dtype the
// kernel is not built for.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* bm,
                          const void* cm, void* y, void* fin, void* scratch, int bsz, int s,
                          int h, int p, int g, int n, int chunk, long long x_sb, long long x_ss,
                          long long x_sh, long long d_sb, long long d_ss, long long d_sh,
                          long long b_sb, long long b_ss, long long b_sg, long long c_sb,
                          long long c_ss, long long c_sg, int dtype, void* stream) {
  if (bsz <= 0 || h <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || s % chunk != 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 || p > 64 ||
      n > 128 || (dtype != kF32 && dtype != kBF16) ||
      ssd_smem_bytes(p, n, chunk, dtype) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides xs{x_sb, x_ss, x_sh}, ds{d_sb, d_ss, d_sh}, bs{b_sb, b_ss, b_sg},
      cs{c_sb, c_ss, c_sg};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(fin);
  if (dtype == kF32)
    return dispatch_p(p, n, x, dtf, af, bm, cm, yf, ff, bsz, s, h, g, chunk, xs, ds, bs,
                             cs, st);
  const int n_chunks = s / chunk;
  if (scratch == nullptr || n_chunks > 65535 || bsz * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(x) && aligned16(bm) && aligned16(cm) && p % 8 == 0 && n % 8 == 0 &&
                   x_sb % 8 == 0 && x_ss % 8 == 0 && x_sh % 8 == 0 && b_sb % 8 == 0 &&
                   b_ss % 8 == 0 && b_sg % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0 &&
                   c_sg % 8 == 0;
  const size_t states = static_cast<size_t>(bsz) * h * n_chunks * p * n;
  bf16* entering = static_cast<bf16*>(scratch);
  float* contrib = static_cast<float*>(scratch) + states;
  float* chunk_cs = contrib + states;
  const TcArgs args{static_cast<const bf16*>(x), dtf, af, static_cast<const bf16*>(bm),
                    static_cast<const bf16*>(cm), yf, ff, entering, contrib, chunk_cs, s, h, p,
                    h / g, n, chunk, n_chunks, vec, xs, ds, bs, cs};
  return dispatch_tc(args, bsz, st);
}
