// Chunked WKV6 (the RWKV6 linear-attention recurrence), forward, for Hopper
// (sm_90a): two chunk-parallel passes.
//
// Replaces the TPU kernel `wkv6_forward` / `_wkv_kernel` in
// src/repro/kernels/wkv6.py.  Same function, per (batch, head):
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(exp(loga_t)) S_{t-1} + k_t^T v_t,    S zeroed at resets,
// in the chunked form of src/repro/models/rwkv.py: within a chunk of L
// tokens, cw is the running sum of loga, cwm1 = cw - loga, and R the running
// count of resets; a pair (t, s) interacts iff R_t == R_s, with weight
// exp(cwm1_t - cw_s), the decay over the tokens strictly between.  Every
// exponent is such a decay sum over a causal range, clamped to <= 0, so
// nothing overflows and nothing is rescaled.  Here each is taken over its
// own range (exp of a running sum of loga or of whole sub-chunks' totals,
// or a running product of the per-token decays exp(loga)), never formed
// from the difference of two cumsums: in float32 that difference loses
// about 6e-8 |cw|, which at steep decays (cw near -1000) moves outputs
// past 5e-5 / 5e-4 of the exact answer.  Resets are counts, never
// a penalty folded into the float32 cumsum.  Also writes the final state,
// which the JAX path (`wkv6_chunked(return_state=True)`) returns and
// prefill needs.
//
// Design.  No CTA waits on another; the state between chunks goes through
// device memory.
//   * Pass 1, `wkv6_state_kernel`, grid (dk / BK, h, b), BK = 32: each CTA
//     walks the chunks of its (b, h) in order, holding BK rows of the
//     (dk, dv) state in registers (a 2 x 4 tile per thread).  Per chunk it
//     writes the state ENTERING the chunk to `states` (b, h, nc, dk, dv),
//     then S <- dec * S + k_hat^T v, with dec = exp(cw_last) if the chunk
//     has no reset (else 0) and k_hat_s = k_s exp(decay over (s, L)) where
//     R_s == R_last (else 0).  The state is split by its rows (k's columns),
//     not by dv: a row block needs cw and k_hat of its own columns only, so
//     the scan and the exps are not repeated across CTAs; only v is read by
//     both.  k, loga and v come in by cp.async one chunk ahead (two
//     stages).  The scan's second half makes k_hat in place from registers.
//     The walk is a chain of nc steps: pass 1 is bound by it, not by bytes.
//   * Pass 2, `wkv6_output_kernel`, grid (nc, h, b): each CTA forms one
//     chunk's outputs from its entering state alone:
//         o = r_q S_c + A v + (r . (u * k)) v,
//     r_q = r exp(decay over [0, t)) where R_t == 0 (else 0), that decay
//     summed as the totals of the sub-chunks before t's and the running
//     sum within it.  The inputs come in by
//     cp.async, all at once; the state after the diagonal blocks (below).
//     The pair weights A are built by sub-chunks of SUB = 16 tokens.
//     A diagonal 16 x 16 block's weights are running products of the
//     per-token decays d = exp(loga), one expf per (s, i).  A block below
//     the diagonal (query sub-chunk T, key sub-chunk S < T) is a plain
//     product at T's first token 16 T:
//         A_TS = (r_T * exp(decay over [16 T, t))) .
//                (k_S * exp(decay over (s, 16 T)))^T,
//     both exponents <= 0, so neither factor overflows (a factor that
//     underflows stands for a true weight below e^-87); the reset mask
//     R_t == R_s is applied after the product.  The k factor depends on T
//     and is made anew for each T; the three are made at once into regions
//     whose first use is over, then all blocks below the diagonal are
//     multiplied in one phase.  Pass 2's expf per chunk at L = dk = 64:
//     11,648, against 133k for one per (t, s, i).  A diagonal block's
//     thread keeps the r of its two rows in registers over their 15 keys.
//   * Pass 2 is launched with programmatic stream serialisation: its CTAs
//     may start on SMs that pass 1 leaves idle and stage their inputs, the
//     scan and the diagonal blocks, and `griddepcontrol.wait` (which waits
//     for the whole pass-1 grid and its writes, as stream order would)
//     comes before the first read of `states`, and every CTA runs it
//     before it ends.  No CTA waits on another.
//   * rwkv6-3b's shapes (dk = 64, chunk 64) are compiled with those sizes
//     as constants (loop bounds and index math); other shapes take the
//     same code with runtime sizes.
//   * Both passes sum loga by the same column segments of 16 rows, and
//     count R by ballots.  Tokens past s, and the rows that pad a chunk to
//     whole sub-chunks, read as zeros with no reset: they add nothing to o
//     or to the state.
//   * float32 FMA throughout, with expf (not __expf), to hold 5e-5 against
//     the sequential oracle; no tensor cores (TF32 cannot hold that).
//
// What bounds it on the H100: at rwkv6-3b serving shapes (b 4, s 512, 40
// heads, dk 64, one reset per row) the function's inputs and outputs are
// ~107 MB (0.032 ms at 3.35 TB/s) and this decomposition's operations
// ~2.1 G, an expf counted as one (0.031 ms at 67 TFLOP/s), so the bytes
// bound it.  The design itself moves ~210 MB (k and loga twice, the
// entering states out and back).  Neither pass is near that: pass 1 is a
// chain of nc dependent steps per CTA at ~2.4 CTAs per SM, whose k_hat^T v
// products alone are 335 M FMA; pass 2 spends its time on instruction
// issue and shared-memory traffic at two CTAs per SM, its shared memory
// (109,312 B) allowing no third.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps in each pass
constexpr int LMAX = 64;       // chunk length
constexpr int DMAX = 64;       // head size, dk = dv
constexpr int SUB = 16;        // sub-chunk length of pass 2's products
constexpr int NSUB = LMAX / SUB;
constexpr int PAD = DMAX + 4;  // row stride: float4 rows, 4 banks apart
constexpr int BK = 32;         // state rows (k columns) per pass-1 CTA
constexpr int DPAD = SUB + 1;  // row stride of a diagonal block
constexpr int ABP = 3 * SUB + 4;  // row stride of the blocks below it

// Pass 1 shared memory, in floats: two stages of k's and loga's column
// slices and v, then dec, segment totals, reset flags (then counts).
// 66,432 B: three CTAs fit on one SM.
constexpr int STAGE1_FLOATS = 2 * LMAX * BK + LMAX * DMAX;
constexpr int SMEM1_BYTES =
    (2 * STAGE1_FLOATS + BK + NSUB * BK) * 4 + LMAX * 4;
// Pass 2: r (then the r factor), k, loga (then d, then A below the diagonal
// blocks), lp (then r_q, then k factors), v, the entering state (then a k
// factor), the diagonal blocks, the sums of earlier segments' totals,
// segment totals, u, reset counts.  109,312 B: two CTAs fit on one SM.
constexpr int SMEM2_FLOATS = 4 * LMAX * PAD + 2 * LMAX * DMAX +
                             NSUB * SUB * DPAD + 2 * NSUB * DMAX + DMAX;
constexpr int SMEM2_BYTES = SMEM2_FLOATS * 4 + LMAX * 4;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* loga;
  const float* u;
  const void* reset;  // (b, s) uint8 or int32
  float* out;         // (b, s, h, dk)
  float* states;      // (b, h, nc, dk, dk) contiguous: state entering chunk c
  float* state;       // (b, h, dk, dk) contiguous, or null
  int h, s, dk, chunk, nc, rst_bytes;
  int vec;            // 1: every row of r, k, v, loga is 16-byte aligned
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long a_sb, a_ss, a_sh;
  long long o_sb, o_ss, o_sh;
  long long u_sh, rst_sb;
};

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts copying rows [0, rows) of a (rows, ncols) tile, row t at
// src + (t0 + t) * ss, into dst (row stride dpad), without waiting; rows
// t >= L or t0 + t >= s are zero-filled.  16-byte copies where `vec`, else
// 4-byte ones.
__device__ __forceinline__ void stage_tile(float* dst, int dpad,
                                           const float* src, long long ss,
                                           int t0, int L, int s, int rows,
                                           int ncols, int vec, int tid) {
  const int w = vec ? 4 : 1, n = ncols / w;
  for (int e = tid; e < rows * n; e += THREADS) {
    const int t = e / n, c = (e - t * n) * w;
    const bool in = t < L && t0 + t < s;
    cp_async(dst + t * dpad + c, in ? src + (t0 + t) * ss + c : src, 4 * w,
             in);
  }
}

__device__ __forceinline__ int reset_flag(const Params& p, int ib,
                                          long long tt) {
  const long long off = ib * p.rst_sb + tt;
  return p.rst_bytes == 1 ? static_cast<const uint8_t*>(p.reset)[off] != 0
                          : static_cast<const int*>(p.reset)[off] != 0;
}

// Sums of loga down each column of `la` (row stride `pad`, rows [0, rows),
// rows a multiple of SUB), by sub-chunks: to `lp` the decay over the rows
// of the sub-chunk before t, lp_t = sum of loga over [16 T, t); to `tot`
// the sub-chunk's total; to `base` the sum of the totals of the sub-chunks
// before it.  Thread (i, g) takes column i of sub-chunk g.  Ends with the
// block synchronised.
__device__ __forceinline__ void scan_local(const float* la, int pad,
                                           float* lp, float* tot,
                                           float* base, int rows, int dk,
                                           int tid) {
  const int i = tid & (DMAX - 1), g = tid / DMAX;
  const bool mine = i < dk && g * SUB < rows;
  if (mine) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      lp[(g * SUB + t) * pad + i] = acc;
      acc += la[(g * SUB + t) * pad + i];
    }
    tot[g * DMAX + i] = acc;
  }
  __syncthreads();
  if (mine) {
    float b = 0.f;
    for (int gg = 0; gg < g; ++gg) b += tot[gg * DMAX + i];
    base[g * DMAX + i] = b;
  }
  __syncthreads();
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
__global__ void __launch_bounds__(THREADS, 3) wkv6_state_kernel(
    const Params p) {
  // Pass 2 may be scheduled on SMs this pass leaves idle; it waits for
  // this grid to complete before it reads `states`.
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float4 smem4[];
  // Two stages of k's column slice (then k_hat), (LMAX, BK), v, (LMAX,
  // DMAX), and loga's column slice, (LMAX, BK); then dec, segment totals
  // and reset counts.
  float* stage0 = reinterpret_cast<float*>(smem4);
  float* decs = stage0 + 2 * STAGE1_FLOATS;      // (BK)
  float* tot = decs + BK;                        // (NSUB, BK)
  int* Rs = reinterpret_cast<int*>(tot + NSUB * BK);

  const int i0 = blockIdx.x * BK, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, dk = DK ? DK : p.dk, L = LC ? LC : p.chunk;
  const int bk = min(BK, dk - i0);               // a multiple of 4
  const int rows = (L + SUB - 1) / SUB * SUB;
  const float* kg = p.k + ib * p.k_sb + ih * p.k_sh + i0;
  const float* vg = p.v + ib * p.v_sb + ih * p.v_sh;
  const float* ag = p.loga + ib * p.a_sb + ih * p.a_sh + i0;
  // The scan's thread: column ci of the slice over rows [16 g, 16 g + 16).
  const int ci = tid % BK, g = tid / BK;
  const bool scans = ci < bk && g * SUB < rows;
  const int g_last = (rows - 1) / SUB;
  // This thread's 2 x 4 tile of the state slice: rows si, si + 1 (of the
  // slice), columns sj..sj+3.  A warp holds 8 row pairs x 4 column quads.
  const int lane = tid % 32, w = tid / 32;
  const int si = 2 * ((w % 2) * 8 + lane / 4);
  const int sj = 4 * ((w / 2) * 4 + lane % 4);
  const bool owner = si < bk && sj < dk;
  float4 S0 = make_float4(0.f, 0.f, 0.f, 0.f), S1 = S0;

  auto fetch = [&](int c) {  // chunk c into stage c % 2, one group
    float* st = stage0 + (c & 1) * STAGE1_FLOATS;
    stage_tile(st, BK, kg, p.k_ss, c * L, L, p.s, rows, bk, p.vec, tid);
    stage_tile(st + LMAX * BK, DMAX, vg, p.v_ss, c * L, L, p.s, rows, dk,
               p.vec, tid);
    stage_tile(st + LMAX * BK + LMAX * DMAX, BK, ag, p.a_ss, c * L, L, p.s,
               rows, bk, p.vec, tid);
    cp_async_commit();
  };
  auto flag = [&](int c) {
    const int t = c * L + tid;
    return tid < L && t < p.s ? reset_flag(p, ib, t) : 0;
  };
  fetch(0);
  int next_flag = flag(0);

  for (int c = 0; c < p.nc; ++c) {
    float* ks = stage0 + (c & 1) * STAGE1_FLOATS;
    const float* vs = ks + LMAX * BK;
    const float* las = vs + LMAX * DMAX;
    // 1. Wait for this chunk; the next one's loads go out.
    if (tid < LMAX) Rs[tid] = next_flag;
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < p.nc) {
      fetch(c + 1);
      next_flag = flag(c + 1);
    }

    // 2. The scan's first half: loga into registers, segment totals; R by
    //    ballots.
    float x[SUB];
    if (scans) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        x[t] = las[(g * SUB + t) * BK + ci];
        acc += x[t];
      }
      tot[g * BK + ci] = acc;
    }
    if (tid >= THREADS - 32) count_resets(Rs, lane);
    __syncthreads();

    // 3. The scan's second half: k -> k_hat in place, row s scaled by the
    //    decay over (s, L), summed from the chunk's end (the totals of the
    //    segments below this one, then this segment's rows upwards); dec
    //    from the sum of all totals; the state entering chunk c goes out.
    const int R_last = Rs[L - 1];
    if (scans) {
      float after = 0.f, cw_last = 0.f;
      for (int gg = 0; gg <= g_last; ++gg) {
        const float tg = tot[gg * BK + ci];
        if (gg > g) after += tg;
        cw_last += tg;
      }
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        const int row = g * SUB + t;
        if (row < L) {
          float* kp = ks + row * BK + ci;
          *kp = Rs[row] == R_last ? *kp * expf(fminf(after, 0.f)) : 0.f;
        }
        after += x[t];
      }
      if (g == 0) decs[ci] = R_last == 0 ? expf(fminf(cw_last, 0.f)) : 0.f;
    }
    float* dst = p.states +
                 ((static_cast<long long>(ib) * p.h + ih) * p.nc + c) * dk *
                     dk +
                 (i0 + si) * dk + sj;
    if (owner) {
      *reinterpret_cast<float4*>(dst) = S0;
      *reinterpret_cast<float4*>(dst + dk) = S1;
    }
    __syncthreads();

    // 4. S <- dec S + k_hat^T v on this thread's tile.
    if (owner) {
      const float d0 = decs[si], d1 = decs[si + 1];
      S0 = make_float4(S0.x * d0, S0.y * d0, S0.z * d0, S0.w * d0);
      S1 = make_float4(S1.x * d1, S1.y * d1, S1.z * d1, S1.w * d1);
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float2 kh = *reinterpret_cast<const float2*>(ks + s * BK + si);
        const float4 v4 = f4(vs + s * DMAX + sj);
        fma4(S0, kh.x, v4);
        fma4(S1, kh.y, v4);
      }
    }
    __syncthreads();
  }

  if (p.state != nullptr && owner) {
    float* dst = p.state +
                 (static_cast<long long>(ib) * p.h + ih) * dk * dk +
                 (i0 + si) * dk + sj;
    *reinterpret_cast<float4*>(dst) = S0;
    *reinterpret_cast<float4*>(dst + dk) = S1;
  }
}

// ------------------------------------------------------------- pass 2
template <int DK, int LC>
__global__ void __launch_bounds__(THREADS, 2) wkv6_output_kernel(
    const Params p) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // (LMAX, PAD): r, r factor
  float* ks = rs + LMAX * PAD;                   // (LMAX, PAD)
  float* las = ks + LMAX * PAD;                  // (LMAX, PAD): loga, d, A
  float* qs = las + LMAX * PAD;                  // (LMAX, PAD): lp, r_q
  float* vs = qs + LMAX * PAD;                   // (LMAX, DMAX)
  float* Ss = vs + LMAX * DMAX;                  // (DMAX, DMAX), k factors
  float* Ad = Ss + DMAX * DMAX;                  // (NSUB, SUB, DPAD)
  float* bases = Ad + NSUB * SUB * DPAD;         // (NSUB, DMAX)
  float* tot = bases + NSUB * DMAX;              // (NSUB, DMAX)
  float* us = tot + NSUB * DMAX;                 // (DMAX)
  int* Rs = reinterpret_cast<int*>(us + DMAX);   // (LMAX)

  const int c = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, dk = DK ? DK : p.dk, dk4 = dk / 4;
  const int L = LC ? LC : p.chunk;
  const int nT = (L + SUB - 1) / SUB, rows = nT * SUB;
  const int t0 = c * L;
  const float* rg = p.r + ib * p.r_sb + ih * p.r_sh;
  const float* kg = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vg = p.v + ib * p.v_sb + ih * p.v_sh;
  const float* ag = p.loga + ib * p.a_sb + ih * p.a_sh;
  const float* Sg = p.states +
                    ((static_cast<long long>(ib) * p.h + ih) * p.nc + c) *
                        dk * dk;

  // 1. Stage r, k, loga, v (zeros past s and past L) by cp.async, all in
  //    flight at once; u and the reset flags.
  stage_tile(rs, PAD, rg, p.r_ss, t0, L, p.s, rows, dk, p.vec, tid);
  stage_tile(ks, PAD, kg, p.k_ss, t0, L, p.s, rows, dk, p.vec, tid);
  stage_tile(las, PAD, ag, p.a_ss, t0, L, p.s, rows, dk, p.vec, tid);
  stage_tile(vs, DMAX, vg, p.v_ss, t0, L, p.s, rows, dk, p.vec, tid);
  cp_async_commit();
  if (tid < dk) us[tid] = p.u[ih * p.u_sh + tid];
  if (tid < LMAX)
    Rs[tid] = tid < L && t0 + tid < p.s ? reset_flag(p, ib, t0 + tid) : 0;
  cp_async_wait<0>();
  __syncthreads();

  // 2. The sub-chunk sums of loga; then loga -> the per-token decay d =
  //    exp(loga) in place; R by ballots.
  scan_local(las, PAD, qs, tot, bases, rows, dk, tid);
  for (int e = tid; e < rows * dk4; e += THREADS) {
    const int t = e / dk4, i = 4 * (e - t * dk4);
    float4& a = *reinterpret_cast<float4*>(las + t * PAD + i);
    a = make_float4(expf(fminf(a.x, 0.f)), expf(fminf(a.y, 0.f)),
                    expf(fminf(a.z, 0.f)), expf(fminf(a.w, 0.f)));
  }
  if (tid < 32) count_resets(Rs, tid);
  __syncthreads();

  // 3. Diagonal blocks: Ad[T][t][s], s <= t, with the u bonus on t == s.
  //    Thread (T, p, e) takes rows p and 15 - p of block T, whose p + (15 -
  //    p) keys make a fixed trip of 15, over every eighth float4 of i (e,
  //    e + 8); its r stays in registers, and the eight lanes of a pair add
  //    up by shuffles.  Each row walks its keys downwards from t - 1, so
  //    the weight, the decay over (s, t), is a running product of d.
  static_assert(THREADS == NSUB * 8 * 8, "one thread per (T, p, e)");
  {
    const int e = tid % 8, pr = tid / 8 % 8, T = tid / 64;
    if (T < nT) {  // whole warps
      const int ta = T * SUB + pr, tb = T * SUB + SUB - 1 - pr;
      float4 ra[2], rb[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int i = 4 * min(e + 8 * m, dk4 - 1);
        ra[m] = f4(rs + ta * PAD + i);
        rb[m] = f4(rs + tb * PAD + i);
      }
      const bool on0 = e < dk4, on1 = e + 8 < dk4;
      // the u bonus of both rows
      float ba = 0.f, bb = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 0 ? on0 : on1) {
          const int i = 4 * (e + 8 * m);
          const float4 u4 = f4(us + i), ka = f4(ks + ta * PAD + i);
          const float4 kb = f4(ks + tb * PAD + i);
          ba += ra[m].x * u4.x * ka.x + ra[m].y * u4.y * ka.y +
                ra[m].z * u4.z * ka.z + ra[m].w * u4.w * ka.w;
          bb += rb[m].x * u4.x * kb.x + rb[m].y * u4.y * kb.y +
                rb[m].z * u4.z * kb.z + rb[m].w * u4.w * kb.w;
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2) {
        ba += __shfl_xor_sync(0xffffffffu, ba, off);
        bb += __shfl_xor_sync(0xffffffffu, bb, off);
      }
      if (e == 0) {
        Ad[ta * DPAD + pr] = ba;
        Ad[tb * DPAD + SUB - 1 - pr] = bb;
      }
      // row ta takes keys pr - 1 .. 0, then row tb keys 14 - pr .. 0
      float4 w[2];
      for (int jj = 0; jj < SUB - 1; ++jj) {
        const bool first = jj < pr;
        const int t = first ? ta : tb, sl = first ? pr - 1 - jj : SUB - 2 - jj;
        const int s = T * SUB + sl;
        if (jj == 0 || jj == pr) w[0] = w[1] = make_float4(1.f, 1.f, 1.f, 1.f);
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 0 ? on0 : on1) {
            const int i = 4 * (e + 8 * m);
            const float4 r4 = first ? ra[m] : rb[m];
            const float4 k4 = f4(ks + s * PAD + i);
            const float4 d4 = f4(las + s * PAD + i);
            acc += r4.x * k4.x * w[m].x;
            acc += r4.y * k4.y * w[m].y;
            acc += r4.z * k4.z * w[m].z;
            acc += r4.w * k4.w * w[m].w;
            w[m].x *= d4.x;
            w[m].y *= d4.y;
            w[m].z *= d4.z;
            w[m].w *= d4.w;
          }
        }
#pragma unroll
        for (int off = 1; off < 8; off *= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (e == 0) Ad[t * DPAD + sl] = Rs[t] == Rs[s] ? acc : 0.f;
      }
    }
  }
  __syncthreads();

  // 4. r_q = r exp(base_T + lp) where no reset has come in the chunk, in
  //    place of lp; the r factor r exp(lp) in place of r (rows of T >= 1).
  //    The entering state, pass 1's output, is first read from here on;
  //    it adds nothing in chunk 0 (zero) or where the chunk's first token
  //    resets (r_q = 0), and is then neither awaited nor read.
  const bool carried = c > 0 && Rs[0] == 0;
  if (carried) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    stage_tile(Ss, DMAX, Sg, dk, 0, dk, dk, dk, dk, 1, tid);
    cp_async_commit();
  }
  for (int e = tid; e < rows * dk; e += THREADS) {
    const int t = e / dk, i = e - t * dk, T = t / SUB;
    const float x = rs[t * PAD + i], m = qs[t * PAD + i];
    qs[t * PAD + i] =
        Rs[t] == 0 ? x * expf(fminf(bases[T * DMAX + i] + m, 0.f)) : 0.f;
    if (T > 0) rs[t * PAD + i] = x * expf(fminf(m, 0.f));
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. This thread's outputs: rows T * SUB + tl for every T, columns
  //    j..j+3.  acc[T] = r_q S_c + the diagonal block's A v + the bonus.
  const int tl = tid / 16, j = (tid % 16) * 4;
  const bool cols = j < dk;
  float4 acc[NSUB];
#pragma unroll
  for (int T = 0; T < NSUB; ++T) acc[T] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cols) {
    for (int i = 0; carried && i < dk; i += 4) {
      const float4 s0 = f4(Ss + i * DMAX + j), s1 = f4(Ss + (i + 1) * DMAX + j);
      const float4 s2 = f4(Ss + (i + 2) * DMAX + j);
      const float4 s3 = f4(Ss + (i + 3) * DMAX + j);
#pragma unroll
      for (int T = 0; T < NSUB; ++T) {
        if (T < nT) {
          const float4 q4 = f4(qs + (T * SUB + tl) * PAD + i);
          fma4(acc[T], q4.x, s0);
          fma4(acc[T], q4.y, s1);
          fma4(acc[T], q4.z, s2);
          fma4(acc[T], q4.w, s3);
        }
      }
    }
#pragma unroll
    for (int T = 0; T < NSUB; ++T) {
      if (T < nT) {
        for (int sl = 0; sl <= tl; ++sl)
          fma4(acc[T], Ad[(T * SUB + tl) * DPAD + sl],
               f4(vs + (T * SUB + sl) * DMAX + j));
      }
    }
  }
  __syncthreads();

  // 6. Blocks below the diagonal, all query sub-chunks T at once.  The k
  //    factor of each T over keys [0, T * SUB), into the dead r_q and S
  //    regions: key s of sub-chunk S < T scaled by the decay over (s, 16 T),
  //    the product of d over the rows of S after s, taken upwards from S's
  //    end, times exp of the totals of the sub-chunks between.  Then A_T =
  //    r factor . k factor, masked where a reset lies between, into the
  //    dead d region; then acc[T] += A_T v.
  auto kfac = [&](int T) {  // (T * SUB, PAD) rows of T's k factor
    return T == 1 ? qs : T == 2 ? qs + SUB * PAD : Ss;
  };
  for (int e = tid; e < nT * (nT - 1) / 2 * dk; e += THREADS) {
    // pairs (T, S) in the order (1, 0), (2, 0), (2, 1), (3, 0), ...
    const int q = e / dk, i = e - q * dk;
    const int T = q < 1 ? 1 : q < 3 ? 2 : 3, S = q - T * (T - 1) / 2;
    float mid = 0.f;
    for (int U = S + 1; U < T; ++U) mid += tot[U * DMAX + i];
    const float em = expf(fminf(mid, 0.f));
    float* kf = kfac(T);
    float after = 1.f;
#pragma unroll
    for (int sl = SUB - 1; sl >= 0; --sl) {
      const int s = S * SUB + sl;
      kf[s * PAD + i] = ks[s * PAD + i] * (after * em);
      after *= las[s * PAD + i];
    }
  }
  __syncthreads();
  float* Abig = las;  // (3 * SUB, ABP): row T * SUB + a - SUB, key s
  for (int e = tid; e < 32 * nT * (nT - 1); e += THREADS) {
    // four query rows a0..a0+3 of T against key s: one k-factor load
    // feeds four products
    const int T = e < 64 ? 1 : e < 192 ? 2 : 3;
    const int idx = e - 32 * T * (T - 1), keys = T * SUB;
    const int a0 = idx / keys * 4, s = idx - idx / keys * keys;
    const float* rt = rs + (T * SUB + a0) * PAD;
    const float* kr = kfac(T) + s * PAD;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    for (int i = 0; i < dk; i += 4) {
      const float4 k4 = f4(kr + i);
      d0 = dot4(f4(rt + i), k4, d0);
      d1 = dot4(f4(rt + PAD + i), k4, d1);
      d2 = dot4(f4(rt + 2 * PAD + i), k4, d2);
      d3 = dot4(f4(rt + 3 * PAD + i), k4, d3);
    }
    const int Rk = Rs[s], t = T * SUB + a0;
    float* ab = Abig + (t - SUB) * ABP + s;
    ab[0] = Rs[t] == Rk ? d0 : 0.f;
    ab[ABP] = Rs[t + 1] == Rk ? d1 : 0.f;
    ab[2 * ABP] = Rs[t + 2] == Rk ? d2 : 0.f;
    ab[3 * ABP] = Rs[t + 3] == Rk ? d3 : 0.f;
  }
  __syncthreads();
  if (cols) {
    for (int s = 0; s < (nT - 1) * SUB; ++s) {
      const float4 v4 = f4(vs + s * DMAX + j);
#pragma unroll
      for (int T = 1; T < NSUB; ++T)
        if (T < nT && s < T * SUB)
          fma4(acc[T], Abig[((T - 1) * SUB + tl) * ABP + s], v4);
    }
  }

  // 7. Write the rows that exist.
  if (cols) {
    float* og = p.out + ib * p.o_sb + ih * p.o_sh + j;
#pragma unroll
    for (int T = 0; T < NSUB; ++T) {
      const int t = T * SUB + tl;
      if (T < nT && t < L && t0 + t < p.s) {
        float* o = og + static_cast<long long>(t0 + t) * p.o_ss;
        o[0] = acc[T].x;
        o[1] = acc[T].y;
        o[2] = acc[T].z;
        o[3] = acc[T].w;
      }
    }
  }
  // Every CTA ends after pass 1 has ended, so whatever follows this grid on
  // the stream, or in a graph, also follows pass 1's writes (the final
  // state, the scratch) even when no CTA here read the scratch.
  if (!carried) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Both passes on `st`, in order; the first non-zero cudaError_t.
template <int DK, int LC>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_state_kernel<DK, LC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM1_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_output_kernel<DK, LC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM2_BYTES);
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<DK, LC><<<dim3((p.dk + BK - 1) / BK, p.h, b), THREADS,
                              SMEM1_BYTES, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nc, p.h, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM2_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv6_output_kernel<DK, LC>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; r, k, v, loga and out are (b, s, h, dk) with a
// unit last stride, u is (h, dk), reset (b, s) of rst_bytes (1 or 4) each.
// states is scratch of (b, h, nc, dk, dk) floats, nc = ceil(s / chunk),
// filled with the state entering each chunk; state may be null.  Launches
// the two passes on `stream` and returns the first non-zero cudaError_t;
// 0 means both were accepted.
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const void* loga,
    const void* u, const void* reset, void* out, void* states, void* state,
    int b, int h, int s, int dk, int chunk, int rst_bytes, int vec,
    long long r_sb,
    long long r_ss, long long r_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long a_sb, long long a_ss, long long a_sh, long long o_sb,
    long long o_ss, long long o_sh, long long u_sh, long long rst_sb,
    void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || dk < 4 || dk > DMAX || dk % 4 != 0 ||
      chunk < 1 || chunk > LMAX || (rst_bytes != 1 && rst_bytes != 4) ||
      states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.loga = static_cast<const float*>(loga);
  p.u = static_cast<const float*>(u);
  p.reset = reset;
  p.out = static_cast<float*>(out);
  p.states = static_cast<float*>(states);
  p.state = static_cast<float*>(state);
  p.h = h;
  p.s = s;
  p.dk = dk;
  p.chunk = chunk;
  p.nc = (s + chunk - 1) / chunk;
  p.rst_bytes = rst_bytes;
  p.vec = vec;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.a_sb = a_sb; p.a_ss = a_ss; p.a_sh = a_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.u_sh = u_sh;
  p.rst_sb = rst_sb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rwkv6-3b's shapes get compile-time loop bounds and index math
  return static_cast<int>(dk == DMAX && chunk == LMAX
                              ? launch<DMAX, LMAX>(p, b, st)
                              : launch<0, 0>(p, b, st));
}
