// Chunked WKV6 (the RWKV6 linear-attention recurrence), backward, for
// Hopper (sm_90a): the gradients of `wkv6.cu`'s function with respect to
// r, k, v, loga and u, given dO, the gradient of its output.
//
// Replaces no TPU kernel: the JAX package differentiates the
// `jax.checkpoint`-ed chunk scan of `wkv6_chunked` (src/repro/models/
// rwkv.py:112) with autodiff.  The plain version is autograd of
// `ref.wkv6_chunked` (`ref.wkv6_bwd_ref`); `ref.wkv6_bwd_two_pass` is this
// kernel's decomposition in plain PyTorch.
//
// The function, per (batch, head), in the chunked form of wkv6.cu: within
// a chunk of L tokens with entering state S (dk, dv), R the running count
// of resets,
//     o_t = r_q,t S + sum_{s<t} A[t,s] v_s + B_t v_t
//     S'  = dec S + sum_s k_hat_s^T v_s
// where r_q,t = r_t Pq_t, Pq_t the decay over [0, t), where R_t == 0 (else
// 0); k_hat_s = k_s Pk_s, Pk_s the decay over (s, L), where R_s == R_last
// (else 0); dec the decay over [0, L) where R_last == 0 (else 0);
// A[t,s] = sum_i r_t,i k_s,i W[t,s,i], W the decay over (s, t), where
// R_s == R_t (else 0); B_t = sum_i r_t,i u_i k_t,i.  A decay over a range is
// exp of the sum of loga over it.
//
// Derivation.  Let dS be the gradient of the state leaving the chunk (0 for
// the last chunk: no gradient of the final state is taken).  Then
//   * the state entering the chunk gets dec dS + r_q^T dO, which is the dS
//     of the chunk before: pass 1 below;
//   * with dA[t,s] = dO_t . v_s on the pairs A keeps and dB_t = dO_t . v_t,
//       dr_t = Pq_t (dO_t S^T) + sum_s dA[t,s] k_s W[t,s] + dB_t u k_t
//       dk_s = Pk_s (v_s dS^T) + sum_t dA[t,s] r_t W[t,s] + dB_s u r_s
//       dv_s = k_hat_s dS + sum_t A[t,s] dO_t + B_s dO_s
//       du   = sum over chunks and tokens of dB_t r_t k_t
//     (the masks of r_q and k_hat carry into their terms);
//   * loga_m (column i) sits in the exponent of every decay whose range
//     holds m, each adding (its term's gradient) x (its value): Pq_t for
//     every t > m, giving r_t (dr_t's first term); Pk_s for every s < m,
//     giving k_s (dk_s's first term); dec, giving dec (dS . S summed over
//     dv); W[t,s] for s < m < t, giving x[t,s] = dA[t,s] r_t k_s W[t,s].
//     The x summed over s are r (dr's second term), y's intra part; summed
//     over t, k (dk's second term), z.  The pairs with s < m < t are those
//     of sum_{t>m} sum_{s<t} less those of sum_{s>=m} sum_{t>s}, so with
//     y = r (dr's first two terms) and w = k (dk's first term):
//       dloga_m = sum_{t>m} (y_t - z_t) - z_m + sum_{s<m} w_s + dec (dS.S).
//     Nothing crosses a reset: every term is masked as its forward term is.
//   * Every decay is a running product of the per-token decays d =
//     exp(loga) over its own range (in pass 1 a product of segment
//     products), never exp of the difference of two float32 cumsums, which
//     loses ~6e-8 |cw| and at steep decays moves results past 5e-5 / 5e-4
//     of the exact answer.  Products of d underflow to 0 only where the
//     true decay is below ~1e-38.
//   * `wkv6_chunked` clamps its exponents at 0, and JAX's gradient of
//     `minimum` halves at a tie and is 0 past it.  The two exponents that
//     round to 0 or above are the empty ranges of the pair s = t - 1 and of
//     k_hat at s = L - 1; their derivative with respect to every loga is 0
//     in both forms.  loga is <= 0 (the model's -exp(.)), as in the forward.
//
// Design: three launches on the caller's stream, no atomics, so two calls
// give bitwise-equal gradients.
//   * Pass 1, `wkv6_bwd_state_kernel`, grid (dk / BK, h, b), BK = 32: each
//     CTA walks the chunks of its (b, h) backwards holding BK rows of dS in
//     registers (a 2 x 4 tile a thread), as the forward's pass 1 walks them
//     forwards holding S.  Per chunk it writes dS leaving the chunk to
//     `dstates` (b, h, nc, dk, dv), then dS <- dec dS + r_q^T dO; r_q's
//     decays are products within segments of 8 rows times the products of
//     the segments before.  The walk is a chain of nc steps.
//   * Pass 2, `wkv6_bwd_chunk_kernel`, grid (nc, h, b): each CTA forms one
//     chunk's dr, dk, dv, dloga and its share of du from the chunk's inputs,
//     its entering state (the forward's `chunk_states`) and dS leaving it,
//     all in shared memory (191,488 B, one CTA an SM).  Pq, Pk and dec are
//     running products down each column.  The four (L, dk) x (dk, dk)
//     products (dO S^T, v dS^T, k_hat dS, dO v^T) run on FMA, a 4 x 4
//     output tile a thread.  The pair terms walk, one warp a row and the
//     lanes over i: a row t walks its keys s = t - 1 .. 0 with W a running
//     product of d, forming A[t,s] by a warp sum and dr's pair term; a key
//     s walks its rows t = s + 1 .. L - 1, forming dk's pair term and dv's.
//     Each warp takes rows t and 15 - t of each 16, so the walks balance.
//     Two scans down each column give dloga.
//   * Pass 3, `wkv6_bwd_du_kernel`, grid h: du sums the per-chunk partials
//     in a fixed order.
//   * float32 FMA throughout, with expf, to hold 5e-5 / 5e-4 of the float64
//     oracle; no tensor cores (TF32 cannot hold that).
//
// What bounds it on the H100: at rwkv6-3b's training shape (b 4, s 1024,
// 40 heads, dk 64, L 64) the function reads r, k, v, loga, dO and the
// chunk states and writes dr, dk, dv, dloga: ~420 MB with the dS scratch,
// ~0.13 ms at 3.35 TB/s.  Its operations are ~1.3 M multiply-adds a
// chunk, ~3.4 G in all (~0.1 ms at 67 TFLOP/s).  This first kernel is
// neither: pass 2 runs one CTA of 8 warps an SM, whose walks are chains of
// dependent shared-memory loads and warp sums; pass 1 is a chain of nc
// steps a CTA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps in each pass
constexpr int LMAX = 64;       // chunk length
constexpr int DMAX = 64;       // head size, dk = dv
constexpr int PAD = DMAX + 4;  // row stride of the (t, i) tiles
constexpr int APAD = LMAX + 1; // row stride of A and dA
constexpr int BK = 32;         // dS rows a pass-1 CTA holds
constexpr int SEG = 8;         // rows a segment of pass 1's products
constexpr int NSEG = LMAX / SEG;
static_assert(BK * NSEG == THREADS, "one pass-1 thread a (column, segment)");

// Pass 1: r's and d's column slices (LMAX, BK), dO (LMAX, DMAX), segment
// products (NSEG, BK), dec (BK), reset counts.  41,216 B.
constexpr int SMEM1_BYTES =
    (2 * LMAX * BK + LMAX * DMAX + NSEG * BK + BK) * 4 + LMAX * 4;
// Pass 2: r, k, v, dO, d, Pq, Pk (LMAX, PAD); S, dS (DMAX, PAD); A, dA
// (LMAX, APAD); u, dec, dS.S (DMAX); B, dB (LMAX); reset counts.
constexpr int SMEM2_FLOATS = 7 * LMAX * PAD + 2 * DMAX * PAD +
                             2 * LMAX * APAD + 3 * DMAX + 2 * LMAX;
constexpr int SMEM2_BYTES = SMEM2_FLOATS * 4 + LMAX * 4;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* loga;
  const float* u;
  const float* dout;
  const void* reset;     // (b, s) uint8 or int32
  const float* states;   // (b, h, nc, dk, dk): state entering chunk c
  float* dstates;        // (b, h, nc, dk, dk): dS leaving chunk c
  float* dr;             // dr, dk, dv, dloga: (b, s, h, dk), one layout
  float* dk_;
  float* dv;
  float* dloga;
  float* du_part;        // (b, nc, h, dk)
  float* du;             // (h, dk) contiguous
  int b, h, s, dk, chunk, nc, rst_bytes;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long a_sb, a_ss, a_sh;
  long long o_sb, o_ss, o_sh;
  long long g_sb, g_ss, g_sh;
  long long u_sh, rst_sb;
};

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [0, rows) x columns [0, width) of a tile, row t at src + (t0 + t) *
// ss, into dst (row stride dpad); zeros where t >= L, t0 + t >= s or the
// column is >= ncols.
__device__ __forceinline__ void load_tile(float* dst, int dpad,
                                          const float* src, long long ss,
                                          int t0, int L, int s, int rows,
                                          int ncols, int width, int tid) {
  for (int e = tid; e < rows * width; e += THREADS) {
    const int t = e / width, c = e - t * width;
    const bool in = t < L && t0 + t < s && c < ncols;
    dst[t * dpad + c] = in ? src[(t0 + t) * ss + c] : 0.f;
  }
}

__device__ __forceinline__ int reset_flag(const Params& p, int ib,
                                          long long tt) {
  const long long off = ib * p.rst_sb + tt;
  return p.rst_bytes == 1 ? static_cast<const uint8_t*>(p.reset)[off] != 0
                          : static_cast<const int*>(p.reset)[off] != 0;
}

// Reset flags in Rs[0, LMAX) -> running counts; called by one whole warp.
__device__ __forceinline__ void count_resets(int* Rs, int lane) {
  const unsigned m0 = __ballot_sync(0xffffffffu, Rs[lane] != 0);
  const unsigned m1 = __ballot_sync(0xffffffffu, Rs[lane + 32] != 0);
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes <= lane
  Rs[lane] = __popc(m0 & upto);
  Rs[lane + 32] = __popc(m0) + __popc(m1 & upto);
}

// ------------------------------------------------------------- pass 1
// DK and LC: the head size and the chunk length when they are known at
// compile time (DMAX, LMAX), else 0.
template <int DK, int LC>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_state_kernel(
    const Params p) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);   // (LMAX, BK): r, then r_q
  float* ds = rs + LMAX * BK;                    // (LMAX, BK): loga, then Pq
  float* os = ds + LMAX * BK;                    // (LMAX, DMAX): dO
  float* tot = os + LMAX * DMAX;                 // (NSEG, BK)
  float* decs = tot + NSEG * BK;                 // (BK)
  int* Rs = reinterpret_cast<int*>(decs + BK);   // (LMAX)

  const int i0 = blockIdx.x * BK, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, dk = DK ? DK : p.dk, L = LC ? LC : p.chunk;
  const int bk = min(BK, dk - i0);               // a multiple of 4
  const float* rg = p.r + ib * p.r_sb + ih * p.r_sh + i0;
  const float* ag = p.loga + ib * p.a_sb + ih * p.a_sh + i0;
  const float* og = p.dout + ib * p.o_sb + ih * p.o_sh;
  // the products' thread: column ci of the slice, rows [8 g, 8 g + 8)
  const int ci = tid % BK, g = tid / BK;
  // this thread's 2 x 4 tile of dS: rows si, si + 1 of the slice, columns
  // sj..sj+3, as the forward's pass 1 holds S
  const int lane = tid % 32, w = tid / 32;
  const int si = 2 * ((w % 2) * 8 + lane / 4);
  const int sj = 4 * ((w / 2) * 4 + lane % 4);
  const bool owner = si < bk && sj < dk;
  float4 G0 = make_float4(0.f, 0.f, 0.f, 0.f), G1 = G0;

  for (int c = p.nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    // 1. dS leaving chunk c goes out; the chunk's r, loga, dO and resets
    //    come in.
    if (owner) {
      float* dst = p.dstates +
                   ((static_cast<long long>(ib) * p.h + ih) * p.nc + c) * dk *
                       dk +
                   (i0 + si) * dk + sj;
      *reinterpret_cast<float4*>(dst) = G0;
      *reinterpret_cast<float4*>(dst + dk) = G1;
    }
    load_tile(rs, BK, rg, p.r_ss, t0, L, p.s, LMAX, bk, BK, tid);
    load_tile(ds, BK, ag, p.a_ss, t0, L, p.s, LMAX, bk, BK, tid);
    load_tile(os, DMAX, og, p.o_ss, t0, L, p.s, LMAX, dk, DMAX, tid);
    if (tid < LMAX)
      Rs[tid] = tid < L && t0 + tid < p.s ? reset_flag(p, ib, t0 + tid) : 0;
    __syncthreads();

    // 2. Within each segment, loga -> the product of d over the segment's
    //    rows before t, and the segment's product; R by ballots.
    {
      float prod = 1.f;
#pragma unroll
      for (int t = g * SEG; t < g * SEG + SEG; ++t) {
        const float d = expf(fminf(ds[t * BK + ci], 0.f));
        ds[t * BK + ci] = prod;
        prod *= d;
      }
      tot[g * BK + ci] = prod;
    }
    if (w == 0) count_resets(Rs, lane);
    __syncthreads();

    // 3. r_q = r Pq where no reset has come in the chunk, Pq the products
    //    of the segments before times the product within; dec.
    {
      float before = 1.f;
      for (int gg = 0; gg < g; ++gg) before *= tot[gg * BK + ci];
#pragma unroll
      for (int t = g * SEG; t < g * SEG + SEG; ++t)
        rs[t * BK + ci] =
            Rs[t] == 0 ? rs[t * BK + ci] * (before * ds[t * BK + ci]) : 0.f;
      if (g == 0) {
        float all = 1.f;
        for (int gg = 0; gg < NSEG; ++gg) all *= tot[gg * BK + ci];
        decs[ci] = Rs[LMAX - 1] == 0 ? all : 0.f;
      }
    }
    __syncthreads();

    // 4. dS <- dec dS + r_q^T dO on this thread's tile.
    if (owner) {
      const float d0 = decs[si], d1 = decs[si + 1];
      G0 = make_float4(G0.x * d0, G0.y * d0, G0.z * d0, G0.w * d0);
      G1 = make_float4(G1.x * d1, G1.y * d1, G1.z * d1, G1.w * d1);
#pragma unroll 4
      for (int t = 0; t < L; ++t) {
        const float2 rq = *reinterpret_cast<const float2*>(rs + t * BK + si);
        const float4 o4 = *reinterpret_cast<const float4*>(os + t * DMAX + sj);
        fma4(G0, rq.x, o4);
        fma4(G1, rq.y, o4);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- pass 2
template <int DK, int LC>
__global__ void __launch_bounds__(THREADS, 1) wkv6_bwd_chunk_kernel(
    const Params p) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // r
  float* ks = rs + LMAX * PAD;                   // k, then z
  float* vs = ks + LMAX * PAD;                   // v, then dv's pair terms
  float* os = vs + LMAX * PAD;                   // dO
  float* ds = os + LMAX * PAD;                   // loga, d, dloga's prefix
  float* pq = ds + LMAX * PAD;                   // Pq, dr's state term, y
  float* pk = pq + LMAX * PAD;                   // Pk, dk's state term, w
  float* Ss = pk + LMAX * PAD;                   // (DMAX, PAD): S entering
  float* Gs = Ss + DMAX * PAD;                   // (DMAX, PAD): dS leaving
  float* As = Gs + DMAX * PAD;                   // (LMAX, APAD): A, suffix
  float* dAs = As + LMAX * APAD;                 // (LMAX, APAD): dA
  float* us = dAs + LMAX * APAD;                 // (DMAX)
  float* decv = us + DMAX;                       // (DMAX)
  float* ddec = decv + DMAX;                     // (DMAX): dS . S over dv
  float* Bv = ddec + DMAX;                       // (LMAX)
  float* dBv = Bv + LMAX;                        // (LMAX)
  int* Rs = reinterpret_cast<int*>(dBv + LMAX);  // (LMAX)

  const int c = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int dk = DK ? DK : p.dk, L = LC ? LC : p.chunk, t0 = c * L;
  const long long hc = (static_cast<long long>(ib) * p.h + ih) * p.nc + c;
  const float* rg = p.r + ib * p.r_sb + ih * p.r_sh;
  const float* kg = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vg = p.v + ib * p.v_sb + ih * p.v_sh;
  const float* ag = p.loga + ib * p.a_sb + ih * p.a_sh;
  const float* og = p.dout + ib * p.o_sb + ih * p.o_sh;
  const long long gofs = ib * p.g_sb + ih * p.g_sh;

  // 1. The chunk's inputs (zeros past s, past L and past dk), the entering
  //    state (zero in chunk 0) and dS leaving (zero in the last chunk).
  load_tile(rs, PAD, rg, p.r_ss, t0, L, p.s, LMAX, dk, DMAX, tid);
  load_tile(ks, PAD, kg, p.k_ss, t0, L, p.s, LMAX, dk, DMAX, tid);
  load_tile(vs, PAD, vg, p.v_ss, t0, L, p.s, LMAX, dk, DMAX, tid);
  load_tile(os, PAD, og, p.o_ss, t0, L, p.s, LMAX, dk, DMAX, tid);
  load_tile(ds, PAD, ag, p.a_ss, t0, L, p.s, LMAX, dk, DMAX, tid);
  load_tile(Ss, PAD, p.states + hc * dk * dk, dk, 0, c > 0 ? dk : 0, dk,
            DMAX, dk, DMAX, tid);
  load_tile(Gs, PAD, p.dstates + hc * dk * dk, dk, 0,
            c < p.nc - 1 ? dk : 0, dk, DMAX, dk, DMAX, tid);
  if (tid < DMAX) us[tid] = tid < dk ? p.u[ih * p.u_sh + tid] : 0.f;
  if (tid < LMAX)
    Rs[tid] = tid < L && t0 + tid < p.s ? reset_flag(p, ib, t0 + tid) : 0;
  __syncthreads();

  // 2. R by ballots; loga -> d = exp(loga); B_t and dB_t by warp sums.
  if (w == 0) count_resets(Rs, lane);
  for (int e = tid; e < LMAX * DMAX; e += THREADS) {
    const int t = e / DMAX, i = e - t * DMAX;
    ds[t * PAD + i] = expf(fminf(ds[t * PAD + i], 0.f));
  }
  for (int t = w; t < LMAX; t += THREADS / 32) {
    float bs = 0.f, dbs = 0.f;
    for (int i = lane; i < DMAX; i += 32) {
      bs += rs[t * PAD + i] * us[i] * ks[t * PAD + i];
      dbs += os[t * PAD + i] * vs[t * PAD + i];
    }
    bs = warp_sum(bs);
    dbs = warp_sum(dbs);
    if (lane == 0) {
      Bv[t] = bs;
      dBv[t] = dbs;
    }
  }
  __syncthreads();

  // 3. Down each column: Pq (the product of d over [0, t)) and dec; Pk (over
  //    (s, L)); dS . S over dv; the chunk's share of du.
  if (tid < DMAX) {
    const int i = tid;
    float prod = 1.f;
    for (int t = 0; t < LMAX; ++t) {
      pq[t * PAD + i] = prod;
      prod *= ds[t * PAD + i];
    }
    decv[i] = Rs[LMAX - 1] == 0 ? prod : 0.f;
  } else if (tid < 2 * DMAX) {
    const int i = tid - DMAX;
    float prod = 1.f;
    for (int t = LMAX - 1; t >= 0; --t) {
      pk[t * PAD + i] = prod;
      prod *= ds[t * PAD + i];
    }
  } else if (tid < 3 * DMAX) {
    const int i = tid - 2 * DMAX;
    float acc = 0.f;
    for (int j = 0; j < DMAX; ++j) acc += Gs[i * PAD + j] * Ss[i * PAD + j];
    ddec[i] = acc;
  } else {
    const int i = tid - 3 * DMAX;
    float acc = 0.f;
    for (int t = 0; t < LMAX; ++t)
      acc += dBv[t] * rs[t * PAD + i] * ks[t * PAD + i];
    if (i < dk) p.du_part[((static_cast<long long>(ib) * p.nc + c) * p.h +
                           ih) * dk + i] = acc;
  }
  __syncthreads();

  // 4. The products, a 4 x 4 tile a thread: rows ty + 16 a, columns
  //    tx + 16 b.  dv's state term stays in registers until the end.
  static_assert(LMAX == 64 && DMAX == 64 && THREADS == 256, "4 x 4 tiles");
  const int ty = tid / 16, tx = tid % 16;
  const int R_last = Rs[LMAX - 1];
  float dvs[4][4];
  {
    // dr's state term: Pq (dO S^T) where R_t == 0, in place of Pq; dv's:
    // k_hat dS, k_hat = k Pk where R_s == R_last
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = dvs[a][b] = 0.f;
    for (int j = 0; j < dk; ++j) {
      float x[4], y[4], kh[4], gj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        x[a] = os[t * PAD + j];
        kh[a] = ks[t * PAD + j] * pk[t * PAD + j];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        y[b] = Ss[(tx + 16 * b) * PAD + j];
        gj[b] = Gs[j * PAD + tx + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
          dvs[a][b] = fmaf(kh[a], gj[b], dvs[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = ty + 16 * a;
      const bool q_ok = Rs[t] == 0, k_ok = Rs[t] == R_last;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = tx + 16 * b;
        if (!k_ok) dvs[a][b] = 0.f;
        pq[t * PAD + i] = q_ok ? acc[a][b] * pq[t * PAD + i] : 0.f;
      }
    }
  }
  __syncthreads();
  {
    // dk's state term: Pk (v dS^T) where R_s == R_last, in place of Pk; dA
    // = dO v^T where s < t and R_s == R_t (else 0)
    float acc[4][4], acc2[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = acc2[a][b] = 0.f;
    for (int j = 0; j < dk; ++j) {
      float x[4], o[4], y[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        x[a] = vs[t * PAD + j];
        o[a] = os[t * PAD + j];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = tx + 16 * b;
        y[b] = Gs[n * PAD + j];
        vv[b] = vs[n * PAD + j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
          acc2[a][b] = fmaf(o[a], vv[b], acc2[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = ty + 16 * a;
      const bool k_ok = Rs[t] == R_last;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = tx + 16 * b;   // a column i of pk, a key s of dA
        pk[t * PAD + n] = k_ok ? acc[a][b] * pk[t * PAD + n] : 0.f;
        dAs[t * APAD + n] = n < t && Rs[n] == Rs[t] ? acc2[a][b] : 0.f;
      }
    }
  }
  __syncthreads();

  // 5. Rows: warp w takes rows t = 16 q + w and 16 q + 15 - w, the lanes
  //    columns i = lane, lane + 32.  Row t walks its keys s = t - 1 .. 0,
  //    W[t,s] = the product of d over (s, t) kept as it goes: A[t,s] by a
  //    warp sum, and dr's pair term.  Then y = r (dr's first two terms) in
  //    place of dr's state term, and dr goes out.
  for (int n = 0; n < 2 * LMAX / 16; ++n) {
    const int t = 16 * (n / 2) + ((n & 1) ? 15 - w : w);
    if (t >= L) continue;                        // whole warps
    const float r0 = rs[t * PAD + lane], r1 = rs[t * PAD + lane + 32];
    float w0 = 1.f, w1 = 1.f, a0 = 0.f, a1 = 0.f;
    for (int s = t - 1; s >= 0; --s) {
      const float k0 = ks[s * PAD + lane] * w0;
      const float k1 = ks[s * PAD + lane + 32] * w1;
      const float dA = dAs[t * APAD + s];
      a0 = fmaf(dA, k0, a0);
      a1 = fmaf(dA, k1, a1);
      w0 *= ds[s * PAD + lane];
      w1 *= ds[s * PAD + lane + 32];
      const float part = warp_sum(fmaf(r0, k0, r1 * k1));
      if (lane == 0) As[t * APAD + s] = Rs[s] == Rs[t] ? part : 0.f;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = lane + 32 * m;
      const float state = pq[t * PAD + i], pair = m ? a1 : a0;
      pq[t * PAD + i] = (m ? r1 : r0) * (state + pair);
      if (i < dk && t0 + t < p.s)
        p.dr[gofs + static_cast<long long>(t0 + t) * p.g_ss + i] =
            state + pair + dBv[t] * us[i] * ks[t * PAD + i];
    }
  }
  __syncthreads();

  // 6. Keys: warp w takes keys s = 16 q + w and 16 q + 15 - w.  Key s walks
  //    its rows t = s + 1 .. L - 1 with W[t,s] kept as it goes: dk's pair
  //    term (lanes over i) and dv's (lanes over j).  Then dk goes out, z = k
  //    (dk's pair term) in place of k, w = k (dk's state term) in place of
  //    it, and dv's pair and bonus terms in place of v.
  for (int n = 0; n < 2 * LMAX / 16; ++n) {
    const int s = 16 * (n / 2) + ((n & 1) ? 15 - w : w);
    if (s >= L) continue;                        // whole warps
    float w0 = 1.f, w1 = 1.f, a0 = 0.f, a1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int t = s + 1; t < L; ++t) {
      const float dA = dAs[t * APAD + s], A = As[t * APAD + s];
      a0 = fmaf(dA, rs[t * PAD + lane] * w0, a0);
      a1 = fmaf(dA, rs[t * PAD + lane + 32] * w1, a1);
      w0 *= ds[t * PAD + lane];
      w1 *= ds[t * PAD + lane + 32];
      v0 = fmaf(A, os[t * PAD + lane], v0);
      v1 = fmaf(A, os[t * PAD + lane + 32], v1);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = lane + 32 * m;
      const float state = pk[s * PAD + i], pair = m ? a1 : a0;
      const float kk = ks[s * PAD + i];
      if (i < dk && t0 + s < p.s)
        p.dk_[gofs + static_cast<long long>(t0 + s) * p.g_ss + i] =
            state + pair + dBv[s] * us[i] * rs[s * PAD + i];
      pk[s * PAD + i] = kk * state;
      ks[s * PAD + i] = kk * pair;
      vs[s * PAD + i] = (m ? v1 : v0) + Bv[s] * os[s * PAD + i];
    }
  }
  __syncthreads();

  // 7. dv = its state term + the rest; dloga_m = (the sum of y - z over
  //    t > m) - z_m + (the sum of w over s < m) + dec (dS . S): the prefix
  //    into d's place, the suffix into A's, then both out.
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      if (s < L && t0 + s < p.s && j < dk)
        p.dv[gofs + static_cast<long long>(t0 + s) * p.g_ss + j] =
            dvs[a][b] + vs[s * PAD + j];
    }
  }
  if (tid < DMAX) {
    const int i = tid;
    const float base = decv[i] * ddec[i];
    float before = 0.f;
    for (int m = 0; m < L; ++m) {
      ds[m * PAD + i] = before - ks[m * PAD + i] + base;
      before += pk[m * PAD + i];
    }
  } else if (tid < 2 * DMAX) {
    const int i = tid - DMAX;
    float after = 0.f;
    for (int m = L - 1; m >= 0; --m) {
      As[m * APAD + i] = after;
      after += pq[m * PAD + i] - ks[m * PAD + i];
    }
  }
  __syncthreads();
  for (int e = tid; e < L * dk; e += THREADS) {
    const int m = e / dk, i = e - m * dk;
    if (t0 + m < p.s)
      p.dloga[gofs + static_cast<long long>(t0 + m) * p.g_ss + i] =
          ds[m * PAD + i] + As[m * APAD + i];
  }
}

// ------------------------------------------------------------- pass 3
// du[h, i] = the sum of the per-chunk partials over (b, c), in order.
__global__ void wkv6_bwd_du_kernel(const Params p) {
  const int ih = blockIdx.x, i = threadIdx.x;
  if (i >= p.dk) return;
  float acc = 0.f;
  for (int n = 0; n < p.b * p.nc; ++n)
    acc += p.du_part[(static_cast<long long>(n) * p.h + ih) * p.dk + i];
  p.du[ih * p.dk + i] = acc;
}

// The three passes on `st`, in order; the first non-zero cudaError_t.
template <int DK, int LC>
cudaError_t launch(const Params& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_chunk_kernel<DK, LC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM2_BYTES);
  if (err != cudaSuccess) return err;
  wkv6_bwd_state_kernel<DK, LC><<<dim3((p.dk + BK - 1) / BK, p.h, p.b),
                                  THREADS, SMEM1_BYTES, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_chunk_kernel<DK, LC><<<dim3(p.nc, p.h, p.b), THREADS, SMEM2_BYTES,
                                  st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_du_kernel<<<p.h, DMAX, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; r, k, v, loga and dout are (b, s, h, dk) with a
// unit last stride; dr, dk, dv and dloga share one such layout (g_*); u is
// (h, dk), reset (b, s) of rst_bytes (1 or 4) each.  states is the
// forward's (b, h, nc, dk, dk) states entering each chunk, nc = ceil(s /
// chunk); dstates (the same shape) and du_part (b, nc, h, dk) are scratch;
// du is (h, dk) contiguous.  Launches the three passes on `stream` and
// returns the first non-zero cudaError_t; 0 means all were accepted.
extern "C" int wkv6_bwd_launch(
    const void* r, const void* k, const void* v, const void* loga,
    const void* u, const void* reset, const void* dout, const void* states,
    void* dstates, void* dr, void* dk_, void* dv, void* dloga, void* du_part,
    void* du, int b, int h, int s, int dk, int chunk, int rst_bytes,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long a_sb, long long a_ss, long long a_sh,
    long long o_sb, long long o_ss, long long o_sh, long long g_sb,
    long long g_ss, long long g_sh, long long u_sh, long long rst_sb,
    void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || dk < 4 || dk > DMAX || dk % 4 != 0 ||
      chunk < 1 || chunk > LMAX || (rst_bytes != 1 && rst_bytes != 4) ||
      states == nullptr || dstates == nullptr || du_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.loga = static_cast<const float*>(loga);
  p.u = static_cast<const float*>(u);
  p.dout = static_cast<const float*>(dout);
  p.reset = reset;
  p.states = static_cast<const float*>(states);
  p.dstates = static_cast<float*>(dstates);
  p.dr = static_cast<float*>(dr);
  p.dk_ = static_cast<float*>(dk_);
  p.dv = static_cast<float*>(dv);
  p.dloga = static_cast<float*>(dloga);
  p.du_part = static_cast<float*>(du_part);
  p.du = static_cast<float*>(du);
  p.b = b;
  p.h = h;
  p.s = s;
  p.dk = dk;
  p.chunk = chunk;
  p.nc = (s + chunk - 1) / chunk;
  p.rst_bytes = rst_bytes;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.a_sb = a_sb; p.a_ss = a_ss; p.a_sh = a_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.g_sb = g_sb; p.g_ss = g_ss; p.g_sh = g_sh;
  p.u_sh = u_sh;
  p.rst_sb = rst_sb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rwkv6-3b's shapes get compile-time loop bounds and index math
  return static_cast<int>(dk == DMAX && chunk == LMAX
                              ? launch<DMAX, LMAX>(p, st)
                              : launch<0, 0>(p, st));
}
