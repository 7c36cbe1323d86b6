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
//
// Design (simple and right; not fast): the TPU kernel runs a sequential
// (B, H, chunk) grid and carries the state in VMEM scratch between grid
// steps. Here one CTA of 256 threads owns one (batch, head) and walks the
// chunks in a loop, with the (P, N) fp32 state in shared memory (32 KB at
// P 64, N 128). The Q x Q fp32 score tile of a 256-token chunk (256 KB) does
// not fit the 227 KB a CTA may have, so a chunk's y is made in row tiles of
// 64: the tile's C rows are staged once, and for each 64-column tile up to
// the tile's last row the CTA stages B and xdt, forms the masked, decayed
// scores C_rows . B^T (64 x 65 fp32 in shared memory) and adds scores . xdt
// to a 4 x (P/16) register accumulator per thread; then it adds the
// entering-state term and writes y. Only after all row tiles does it update
// the state, each thread owning (P/16) x (N/16) entries in registers. Warp
// 0 scans dt * a for the chunk's cumsum. Rows are padded to N + 1 and P + 1
// floats so that the 16 threads that read 16 different rows of a tile hit
// 16 different banks. Products are fp32 FMAs on the CUDA cores; B and x are
// re-read from L2 by each row tile and each head of a group. Tensor cores
// (mma.sync / wgmma on bf16 tiles), TMA and splitting P over CTAs (80 CTAs
// on 132 SMs at batch 1) are for a later PR.
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
template <typename T, int PJ, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ y,
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
  const T* xb = x + b * xs.b + hh * xs.h;
  const float* db = dt + b * ds.b + hh * ds.h;
  const T* bb = bm + b * bs.b + g * bs.h;
  const T* cb = cm + b * cs.b + g * cs.h;
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
        ct[r * np + k] = r < rows ? to_f32(cb[(c0 + r0 + r) * cs.s + k]) : 0.f;
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
          bt[r * np + k] = r < cols ? to_f32(bb[(c0 + k0 + r) * bs.s + k]) : 0.f;
        }
        for (int i = tid; i < kTile * p; i += kThreads) {
          const int r = i / p, k = i - r * p;
          xt[r * pp + k] = r < cols ? to_f32(xb[(c0 + k0 + r) * xs.s + k]) * dts[k0 + r] : 0.f;
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
        bt[r * np + k] = r < cols ? to_f32(bb[(c0 + k0 + r) * bs.s + k]) : 0.f;
      }
      for (int i = tid; i < kTile * p; i += kThreads) {
        const int r = i / p, k = i - r * p;
        xt[r * pp + k] = r < cols ? to_f32(xb[(c0 + k0 + r) * xs.s + k]) * dts[k0 + r] *
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

template <typename T, int PJ, int NJ>
int launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
           float* y, float* fin, int bsz, int s, int h, int p, int g, int n, int q,
           Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p, n, q);
  auto kernel = ssd_kernel<T, PJ, NJ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(h, bsz), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm), y,
      fin, s, h, p, h / g, n, q, xs, ds, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PJ>
int dispatch_n(int n, const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, float* y, float* fin, int bsz, int s, int h, int p, int g,
               int q, Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t st) {
  if (n <= 16) return launch<T, PJ, 1>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  if (n <= 32) return launch<T, PJ, 2>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  if (n <= 64) return launch<T, PJ, 4>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  if (n <= 128) return launch<T, PJ, 8>(x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, n, q, xs, ds, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_p(int p, int n, const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, float* y, float* fin, int bsz, int s, int h, int g, int q,
               Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t st) {
  if (p <= 16) return dispatch_n<T, 1>(n, x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, q, xs, ds, bs, cs, st);
  if (p <= 32) return dispatch_n<T, 2>(n, x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, q, xs, ds, bs, cs, st);
  if (p <= 64) return dispatch_n<T, 4>(n, x, dt, a, bm, cm, y, fin, bsz, s, h, p, g, q, xs, ds, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared-memory bytes the kernel needs at these shapes, saturated at
// INT_MAX (the wrapper checks them against ssd_smem_limit() before it
// launches).
extern "C" int ssd_smem_bytes(int p, int n, int q) {
  const long long bytes = static_cast<long long>(sizeof(float)) * smem_floats(p, n, q);
  return bytes > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(bytes);
}

extern "C" int ssd_smem_limit() { return kMaxSmem; }

// x (B, S, H, P) and b/c (B, S, G, N) in `dtype`, dt (B, S, H) fp32, each
// given by its (batch, seq, head-or-group) element strides with a unit last
// stride; a (H,) fp32; y (B, S, H, P) and fin (B, H, P, N) fp32, contiguous.
// Needs S % chunk == 0, H % G == 0, P <= 64, N <= 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes or a dtype the
// kernel is not built for.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* bm,
                          const void* cm, void* y, void* fin, int bsz, int s, int h, int p,
                          int g, int n, int chunk, long long x_sb, long long x_ss,
                          long long x_sh, long long d_sb, long long d_ss, long long d_sh,
                          long long b_sb, long long b_ss, long long b_sg, long long c_sb,
                          long long c_ss, long long c_sg, int dtype, void* stream) {
  if (bsz <= 0 || h <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || s % chunk != 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 ||
      sizeof(float) * smem_floats(p, n, chunk) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides xs{x_sb, x_ss, x_sh}, ds{d_sb, d_ss, d_sh}, bs{b_sb, b_ss, b_sg},
      cs{c_sb, c_ss, c_sg};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(fin);
  if (dtype == kF32)
    return dispatch_p<float>(p, n, x, dtf, af, bm, cm, yf, ff, bsz, s, h, g, chunk, xs, ds, bs,
                             cs, st);
  if (dtype == kBF16)
    return dispatch_p<__nv_bfloat16>(p, n, x, dtf, af, bm, cm, yf, ff, bsz, s, h, g, chunk, xs,
                                     ds, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
