// Chunked WKV6 (the RWKV6 linear-attention recurrence), backward, for
// Hopper (sm_90a): the gradients of `wkv6.cu`'s function with respect to
// r, k, v, loga and u, given dO, the gradient of its output.
//
// Replaces no TPU kernel: the JAX package differentiates the
// `jax.checkpoint`-ed chunk scan of `wkv6_chunked` (src/repro/models/
// rwkv.py:112) with autodiff.  The plain version is autograd of
// `ref.wkv6_chunked` (`ref.wkv6_bwd_ref`); `ref.wkv6_bwd_two_pass` is this
// kernel's decomposition in plain PyTorch, in the kernel's order.
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
//   * Every decay is a product of the per-token decays d = exp(loga) over
//     its own range (running products, and products of whole sub-chunks'
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
// What bounds it on the H100: at rwkv6-3b's training shape (b 4, s 1024,
// 40 heads, dk 64, L 64) the function reads r, k, v, loga, dO and the
// chunk states and writes dr, dk, dv, dloga: 419 MB, 0.125 ms at 3.35
// TB/s.  Its operations, ~3.7 GFLOP of float32 FMA, take 0.055 ms at 67
// TFLOP/s, so bytes bound it.  The design moves ~760 MB: pass 1 reads r,
// loga and dO (dO twice, once for each half of dS) and writes dS, which
// pass 2 reads back, with v and S a second time.  What holds it above that
// is instruction issue and latency: pass 2 keeps 16 warps on an SM through
// a dozen phases between barriers, and pass 1 is a chain of 16 steps a CTA.
//
// Design: three launches on the caller's stream, no atomics, so two calls
// give bitwise-equal gradients.
//   * Pass 1, `wkv6_bwd_state_kernel`, grid (dk / BK, h, b), BK = 32: each
//     CTA walks the chunks of its (b, h) backwards holding BK rows of dS in
//     registers (a 2 x 4 tile a thread), as the forward's pass 1 walks them
//     forwards holding S.  Per chunk it writes dS leaving the chunk to
//     `dstates` (b, h, nc, dk, dv), then dS <- dec dS + r_q^T dO; r_q's
//     decays are products within segments of 8 rows times the products of
//     the segments before.  The next chunk's r, loga and dO come in by
//     cp.async while this one is worked (two stages), as in the forward's
//     pass 1.
//   * Pass 2, `wkv6_bwd_chunk_kernel`, grid (nc, h, b): each CTA forms one
//     chunk's dr, dk, dv, dloga and its share of du in shared memory
//     (112,256 B, so two CTAs of 8 warps fit on an SM; the inputs come in
//     by cp.async in three groups, in the order they are first needed).
//     Each thread owns a 4 x 4 tile of every (L, dk) output, rows ty + 16 a
//     (one in each sub-chunk of SUB = 16 tokens) and four adjacent columns,
//     and keeps its sums in registers.  k, v, S and dS, which products read
//     across rows both as x + 16 b and as 4 x + b, lie with their rows'
//     16-byte chunks permuted so that either way eight rows fill eight bank
//     groups (`sw`).  The pair terms go by sub-chunks:
//       - the four (L, dk) x (dk, dk) products (dO S^T, v dS^T, k_hat dS,
//         dO v^T) run on FMA out of shared memory;
//       - a diagonal 16 x 16 block walks its pairs with W a running product
//         of d, at most 15 deep: A's as the forward's pass 2 walks them
//         (eight lanes a pair, the u bonus on A's diagonal); dr's and dk's
//         by each owner along its own rows, the four sub-chunks side by
//         side, which also leaves it qd (the decay over [16 T, t)) and kd
//         (over (s, 16 S + 16));
//       - a block below the diagonal (query sub-chunk T, key sub-chunk
//         S < T) splits each decay at 16 T: with q' = r qd and k' = k kd,
//         put in place of r and k, and mid the decay over the sub-chunks
//         between S and T,
//             A_TS = (q'_T mid) k'_S^T,   dr_T += qd (sum_S mid dA_TS k'_S),
//             dk_S += kd (sum_T mid dA_TS^T q'_T),   dv_S += A_TS^T dO_T,
//         the sums over S and T in Horner form (times one sub-chunk's decay
//         before the next block's product is added), the reset mask applied
//         after each product;
//       - y and z start from each owner's r and k before q' and k' replace
//         them, and take the blocks' terms as q' h and k' h; z waits in v's
//         place, and v comes in again with dS; w = k_hat (dk's state term);
//         dloga by scans down each column in sub-chunks.
//     Everything but dk's and dv's state terms and dec's (dS . S) needs only
//     the chunk's inputs and the forward's states, so pass 2 is launched
//     with programmatic stream serialisation: its CTAs may start on SMs
//     that pass 1 leaves room on, form dr, the pair terms and du's share,
//     and run `griddepcontrol.wait` (which waits for the whole pass-1 grid
//     and its writes, as stream order would) before the first read of
//     `dstates`; every CTA runs it before it ends.
//   * Pass 3, `wkv6_bwd_du_kernel`, grid h: du sums the per-chunk partials
//     in a fixed order.
//   * rwkv6-3b's shapes (dk = 64, chunk 64) are compiled with those sizes
//     as constants; other shapes take the same code with runtime sizes.
//     Tokens past s, rows that pad a chunk to 64 and columns past dk read
//     as zeros with no reset (decay 1): they add nothing.
//   * float32 FMA throughout, with expf, to hold 5e-5 / 5e-4 of the float64
//     oracle; no tensor cores (TF32 cannot hold that).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps in each pass
constexpr int LMAX = 64;       // chunk length
constexpr int DMAX = 64;       // head size, dk = dv
constexpr int SUB = 16;        // sub-chunk length of pass 2's pair terms
constexpr int NSUB = LMAX / SUB;
constexpr int BPAD = SUB + 1;  // row stride of a 16 x 16 block
constexpr int BLK = SUB * BPAD;
constexpr int NBLK = NSUB * (NSUB + 1) / 2;  // the blocks on and below
constexpr int BK = 32;         // dS rows a pass-1 CTA holds
constexpr int SEG = 8;         // rows a segment of pass 1's products
constexpr int NSEG = LMAX / SEG;
static_assert(BK * NSEG == THREADS, "one pass-1 thread a (column, segment)");
static_assert(NSUB * DMAX == THREADS, "one pass-2 thread a (column, sub)");
static_assert(DMAX == 64 && BK == 32, "stage_tile's shifts");

// Pass 1: two stages of r's and loga's column slices (LMAX, BK) and dO
// (LMAX, DMAX); segment products (NSEG, BK), dec (BK), reset counts.
// 66,944 B: three CTAs fit on one SM.
constexpr int STAGE1_FLOATS = 2 * LMAX * BK + LMAX * DMAX;
constexpr int SMEM1_BYTES =
    (2 * STAGE1_FLOATS + NSEG * BK + BK) * 4 + LMAX * 4;
// Pass 2: r, dO, loga, k, v, S (LMAX, DMAX); dA's blocks; the sub-chunks'
// decays and the decays after them (NSUB, DMAX); u, dB, dS.S; reset
// counts.  112,256 B: two CTAs fit on one SM (233,472 B, less 1 KB reserved
// a CTA).
constexpr int SMEM2_FLOATS = 6 * LMAX * DMAX + NBLK * BLK + 2 * NSUB * DMAX +
                             DMAX + LMAX + DMAX;
constexpr int SMEM2_BYTES = SMEM2_FLOATS * 4 + LMAX * 4;
static_assert(2 * (SMEM2_BYTES + 1024) <= 233472, "two pass-2 CTAs an SM");

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
  int vec;               // 1: every row of r, k, v, loga, dO is 16-B aligned
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

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 mul4(const float4 a, const float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float s, const float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}

// a * b + c, elementwise
__device__ __forceinline__ float4 fmav(const float4 a, const float4 b,
                                       const float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

__device__ __forceinline__ float comp(const float4 a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4& at4(float* p) {
  return *reinterpret_cast<float4*>(p);
}

// Where element (row, col) of a swizzled (LMAX, DMAX) tile lies: the
// row's 16-byte chunks permuted by an XOR of (row ^ row / 4) % 8, so that
// the same chunk of rows 4 x + b, or of rows x + 16 b, for eight x lies in
// eight different bank groups.  Pass 2 reads k, v, S and dS across rows in
// both ways.
__device__ __forceinline__ int sw(int row, int col) {
  return row * DMAX +
         ((((col >> 2) ^ ((row ^ (row >> 2)) & 7)) << 2) | (col & 3));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

// Starts copying an (LMAX, width) tile without waiting: row t from src +
// (t0 + t) * ss where t < L and t0 + t < s, its columns [0, ncols); every
// other element is zero-filled.  dst's row stride is width, or the tile is
// swizzled (`sw`, width DMAX) where SW.  16-byte copies where `vec` (ncols
// a multiple of 4), else 4-byte ones.
template <bool SW = false>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long ss, int t0, int L,
                                           int s, int ncols, int width,
                                           int vec, int tid) {
  // width (BK or DMAX) and LMAX are powers of 2: shifts, no division
  const int lw = vec ? 2 : 0, ln = (width == DMAX ? 6 : 5) - lw;
  for (int e = tid; e < LMAX << ln; e += THREADS) {
    const int t = e >> ln, c = (e & ((1 << ln) - 1)) << lw;
    const bool in = t < L && t0 + t < s && c < ncols;
    cp_async(dst + (SW ? sw(t, c) : t * width + c),
             in ? src + (t0 + t) * ss + c : src, 4 << lw, in);
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

// The index of the 16 x 16 block (query sub-chunk T, key sub-chunk S <= T)
// among the blocks on and below the diagonal.
__device__ __forceinline__ int blk(int T, int S) {
  return (T * (T + 1) / 2 + S) * BLK;
}

// ------------------------------------------------------------- pass 1
// DK and LC: the head size and the chunk length when they are known at
// compile time (DMAX, LMAX), else 0.
template <int DK, int LC>
__global__ void __launch_bounds__(THREADS, 3) wkv6_bwd_state_kernel(
    const Params p) {
  // Pass 2 may be scheduled on SMs this pass leaves room on; it waits for
  // this grid to complete before it reads `dstates`.
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float4 smem4[];
  // Two stages of r's column slice (then r_q), (LMAX, BK), loga's (then
  // Pq), (LMAX, BK), and dO, (LMAX, DMAX); then segment products, dec and
  // reset counts.
  float* stage0 = reinterpret_cast<float*>(smem4);
  float* tot = stage0 + 2 * STAGE1_FLOATS;       // (NSEG, BK)
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

  auto fetch = [&](int c) {  // chunk c into stage c % 2, one group
    float* st = stage0 + (c & 1) * STAGE1_FLOATS;
    stage_tile(st, rg, p.r_ss, c * L, L, p.s, bk, BK, p.vec, tid);
    stage_tile(st + LMAX * BK, ag, p.a_ss, c * L, L, p.s, bk, BK, p.vec, tid);
    stage_tile(st + 2 * LMAX * BK, og, p.o_ss, c * L, L, p.s, dk, DMAX, p.vec,
               tid);
    cp_async_commit();
  };
  auto flag = [&](int c) {
    const int t = c * L + tid;
    return tid < L && t < p.s ? reset_flag(p, ib, t) : 0;
  };
  fetch(p.nc - 1);
  int next_flag = flag(p.nc - 1);

  for (int c = p.nc - 1; c >= 0; --c) {
    float* rs = stage0 + (c & 1) * STAGE1_FLOATS;
    float* ds = rs + LMAX * BK;
    const float* os = ds + LMAX * BK;
    // 1. dS leaving chunk c goes out; wait for this chunk; the next one's
    //    loads go out.
    if (owner) {
      float* dst = p.dstates +
                   ((static_cast<long long>(ib) * p.h + ih) * p.nc + c) * dk *
                       dk +
                   (i0 + si) * dk + sj;
      *reinterpret_cast<float4*>(dst) = G0;
      *reinterpret_cast<float4*>(dst + dk) = G1;
    }
    if (tid < LMAX) Rs[tid] = next_flag;
    cp_async_wait<0>();
    __syncthreads();
    if (c > 0) {
      fetch(c - 1);
      next_flag = flag(c - 1);
    }

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
        const float4 o4 = f4(os + t * DMAX + sj);
        fma4(G0, rq.x, o4);
        fma4(G1, rq.y, o4);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- pass 2
template <int DK, int LC>
__global__ void __launch_bounds__(THREADS, 2) wkv6_bwd_chunk_kernel(
    const Params p) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // r, q', z
  float* os = rs + LMAX * DMAX;                  // dO, S
  float* ds = os + LMAX * DMAX;                  // loga, d, y
  float* ks = ds + LMAX * DMAX;                  // k, k', k_hat (swizzled)
  float* vs = ks + LMAX * DMAX;                  // v (swizzled), z, v, w
  float* Ss = vs + LMAX * DMAX;                  // S, A, dS (swizzled S, dS)
  float* dAs = Ss + LMAX * DMAX;                 // (NBLK, SUB, BPAD): dA
  float* tot = dAs + NBLK * BLK;                 // (NSUB, DMAX)
  float* aft = tot + NSUB * DMAX;                // (NSUB, DMAX)
  float* us = aft + NSUB * DMAX;                 // (DMAX)
  float* dBv = us + DMAX;                        // (LMAX)
  float* ddec = dBv + LMAX;                      // (DMAX): dS . S over dv
  int* Rs = reinterpret_cast<int*>(ddec + DMAX);  // (LMAX)

  const int c = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int dk = DK ? DK : p.dk, L = LC ? LC : p.chunk, t0 = c * L;
  const long long hc = (static_cast<long long>(ib) * p.h + ih) * p.nc + c;
  const float* Sg = p.states + hc * dk * dk;
  const long long gofs = ib * p.g_sb + ih * p.g_sh;
  // This thread's 4 x 4 tile of every (L, dk) output: rows ty + 16 a (row
  // ty of sub-chunk a), columns cq .. cq + 3.  A's and dA's blocks below
  // are formed with columns tx + 16 b instead (key tx of sub-chunk b).
  const int ty = tid / 16, tx = tid % 16, cq = 4 * tx;
  const bool cols = cq < dk;

  // 1. The chunk's inputs and its entering state (zero in chunk 0) by
  //    cp.async, all in flight at once in three groups, in the order they
  //    are first needed: loga, dO and v; r and k; S.  u and the reset
  //    flags.
  const float* vg = p.v + ib * p.v_sb + ih * p.v_sh;
  stage_tile(ds, p.loga + ib * p.a_sb + ih * p.a_sh, p.a_ss, t0, L, p.s, dk,
             DMAX, p.vec, tid);
  stage_tile(os, p.dout + ib * p.o_sb + ih * p.o_sh, p.o_ss, t0, L, p.s, dk,
             DMAX, p.vec, tid);
  stage_tile<true>(vs, vg, p.v_ss, t0, L, p.s, dk, DMAX, p.vec, tid);
  cp_async_commit();
  stage_tile(rs, p.r + ib * p.r_sb + ih * p.r_sh, p.r_ss, t0, L, p.s, dk,
             DMAX, p.vec, tid);
  stage_tile<true>(ks, p.k + ib * p.k_sb + ih * p.k_sh, p.k_ss, t0, L, p.s,
                   dk, DMAX, p.vec, tid);
  cp_async_commit();
  stage_tile<true>(Ss, Sg, dk, 0, c > 0 ? dk : 0, dk, dk, DMAX, 1, tid);
  cp_async_commit();
  if (tid < DMAX) us[tid] = tid < dk ? p.u[ih * p.u_sh + tid] : 0.f;
  if (tid < LMAX)
    Rs[tid] = tid < L && t0 + tid < p.s ? reset_flag(p, ib, t0 + tid) : 0;
  cp_async_wait<2>();
  __syncthreads();

  // 2. R by ballots; loga -> d = exp(loga) in place; dB_t by warp sums.
  if (w == 0) count_resets(Rs, lane);
  for (int e = tid; e < LMAX * DMAX / 4; e += THREADS) {
    float4& a = *reinterpret_cast<float4*>(ds + 4 * e);
    a = make_float4(expf(fminf(a.x, 0.f)), expf(fminf(a.y, 0.f)),
                    expf(fminf(a.z, 0.f)), expf(fminf(a.w, 0.f)));
  }
  for (int t = w; t < LMAX; t += THREADS / 32) {
    const float x = warp_sum(
        fmaf(os[t * DMAX + lane], vs[sw(t, lane)],
             os[t * DMAX + lane + 32] * vs[sw(t, lane + 32)]));
    if (lane == 0) dBv[t] = x;
  }
  cp_async_wait<1>();
  __syncthreads();
  // Thread (i, T): the product of d down column i of sub-chunk T, and the
  // sub-chunk's share of du, into aft until it is summed.
  {
    const int i = tid % DMAX, T = tid / DMAX;
    float prod = 1.f, part = 0.f;
#pragma unroll
    for (int t = T * SUB; t < T * SUB + SUB; ++t) {
      prod *= ds[t * DMAX + i];
      part = fmaf(dBv[t], rs[t * DMAX + i] * ks[sw(t, i)], part);
    }
    tot[T * DMAX + i] = prod;
    aft[T * DMAX + i] = part;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < dk) {
    float acc = 0.f;
#pragma unroll
    for (int T = 0; T < NSUB; ++T) acc += aft[T * DMAX + tid];
    p.du_part[((static_cast<long long>(ib) * p.nc + c) * p.h + ih) * dk +
              tid] = acc;
  }

  // 3. dO S^T (dr's state term before its decay) on this thread's tile,
  //    and dA = dO v^T on the blocks on and below the diagonal (columns
  //    tx + 16 b), one pass over dO.
  float xs[NSUB][4], da[NSUB][4];
#pragma unroll
  for (int a = 0; a < NSUB; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) xs[a][b] = da[a][b] = 0.f;
#pragma unroll 2
  for (int j = 0; j < dk; j += 4) {
    float4 o[NSUB], sv[4], vv[4];
#pragma unroll
    for (int a = 0; a < NSUB; ++a) o[a] = f4(os + (ty + SUB * a) * DMAX + j);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      sv[b] = f4(Ss + sw(cq + b, j));
      vv[b] = f4(vs + sw(tx + SUB * b, j));
    }
#pragma unroll
    for (int a = 0; a < NSUB; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        xs[a][b] = dot4(o[a], sv[b], xs[a][b]);
        if (b <= a) da[a][b] = dot4(o[a], vv[b], da[a][b]);
      }
  }
  __syncthreads();  // S and the du partials are read; their regions free
#pragma unroll
  for (int a = 0; a < NSUB; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int t = ty + SUB * a, s = tx + SUB * b;
      const bool keep = (b < a || tx < ty) && Rs[t] == Rs[s];
      dAs[blk(a, b) + ty * BPAD + tx] = keep ? da[a][b] : 0.f;
    }
  // the sub-chunks' decays after each one, for k_hat
  {
    const int i = tid % DMAX, T = tid / DMAX;
    float prod = 1.f;
    for (int U = T + 1; U < NSUB; ++U) prod *= tot[U * DMAX + i];
    aft[T * DMAX + i] = prod;
  }

  // 4. A on the diagonal blocks, as the forward's pass 2 builds it: thread
  //    (T, pr, e) takes rows pr and 15 - pr of block T, whose pr + (15 - pr)
  //    keys make a fixed trip of 15, over float4 e and e + 8 of i; the
  //    eight lanes of a pair add up by shuffles.  Each row walks its keys
  //    downwards from t - 1, so W, the decay over (s, t), is a running
  //    product of d.  The u bonus B_t goes on the block's diagonal.
  {
    const int dk4 = dk / 4;
    const int e = tid % 8, pr = tid / 8 % 8, T = tid / 64;
    const int ta = T * SUB + pr, tb = T * SUB + SUB - 1 - pr;
    float* Ad = Ss + blk(T, T);
    float4 ra[2], rb[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = 4 * min(e + 8 * m, dk4 - 1);
      ra[m] = f4(rs + ta * DMAX + i);
      rb[m] = f4(rs + tb * DMAX + i);
    }
    const bool on0 = e < dk4, on1 = e + 8 < dk4;
    float ba = 0.f, bb = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 0 ? on0 : on1) {
        const int i = 4 * (e + 8 * m);
        const float4 u4 = f4(us + i), ka = f4(ks + sw(ta, i));
        const float4 kb = f4(ks + sw(tb, i));
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
      Ad[pr * BPAD + pr] = ba;
      Ad[(SUB - 1 - pr) * BPAD + SUB - 1 - pr] = bb;
    }
    // row ta takes keys pr - 1 .. 0, then row tb keys 14 - pr .. 0
    float4 wv[2];
#pragma unroll
    for (int jj = 0; jj < SUB - 1; ++jj) {
      const bool first = jj < pr;
      const int tl = first ? pr : SUB - 1 - pr;
      const int sl = first ? pr - 1 - jj : SUB - 2 - jj;
      const int s = T * SUB + sl;
      if (jj == 0 || jj == pr) wv[0] = wv[1] = make_float4(1.f, 1.f, 1.f, 1.f);
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 0 ? on0 : on1) {
          const int i = 4 * (e + 8 * m);
          const float4 r4 = first ? ra[m] : rb[m];
          const float4 k4 = f4(ks + sw(s, i));
          const float4 d4 = f4(ds + s * DMAX + i);
          acc += r4.x * k4.x * wv[m].x;
          acc += r4.y * k4.y * wv[m].y;
          acc += r4.z * k4.z * wv[m].z;
          acc += r4.w * k4.w * wv[m].w;
          wv[m] = mul4(wv[m], d4);
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (e == 0)
        Ad[tl * BPAD + sl] = Rs[T * SUB + tl] == Rs[s] ? acc : 0.f;
    }
  }
  __syncthreads();

  // 5. The diagonal blocks' pair terms of dr and dk, each owner along its
  //    own rows, the four sub-chunks' walks side by side: row t = 16 a + ty
  //    walks its keys s = t - 1 .. 16 a, key s = t its rows t + 1 .. 16 a +
  //    15.  W, a running product of d, ends as qd_t, the decay over
  //    [16 a, t), and kd_s, the decay over (s, 16 a + 16).  Then dr's state
  //    term with its decay base_a qd_t (base_a: the sub-chunks before a)
  //    joins dr's.
  float4 gr[NSUB], gk[NSUB], qd[NSUB], kd[NSUB];
#pragma unroll
  for (int a = 0; a < NSUB; ++a) {
    gr[a] = gk[a] = make_float4(0.f, 0.f, 0.f, 0.f);
    qd[a] = kd[a] = make_float4(1.f, 1.f, 1.f, 1.f);
  }
  for (int m = ty - 1; m >= 0; --m) {
#pragma unroll
    for (int a = 0; a < NSUB; ++a) {
      const int row = SUB * a + m;
      fma4(gr[a], dAs[blk(a, a) + ty * BPAD + m],
           mul4(f4(ks + sw(row, cq)), qd[a]));
      qd[a] = mul4(qd[a], f4(ds + row * DMAX + cq));
    }
  }
  for (int m = ty + 1; m < SUB; ++m) {
#pragma unroll
    for (int a = 0; a < NSUB; ++a) {
      const int row = SUB * a + m;
      fma4(gk[a], dAs[blk(a, a) + m * BPAD + ty],
           mul4(f4(rs + row * DMAX + cq), kd[a]));
      kd[a] = mul4(kd[a], f4(ds + row * DMAX + cq));
    }
  }
#pragma unroll
  for (int a = 0; a < NSUB; ++a) {
    float4 base = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
    for (int U = 0; U < a; ++U) base = mul4(base, f4(tot + U * DMAX + cq));
    const float4 st = make_float4(xs[a][0], xs[a][1], xs[a][2], xs[a][3]);
    if (Rs[ty + SUB * a] == 0) gr[a] = fmav(mul4(base, qd[a]), st, gr[a]);
  }
  __syncthreads();

  // 6. y = r (dr's terms so far) into d's place, z = k (dk's pair terms
  //    so far) into v's (v is read again after pass 1); the u bonus of dr
  //    and dk; then q' = r qd and k' = k kd in place of r and k.
#pragma unroll
  for (int a = 0; a < NSUB; ++a) {
    const int t = ty + SUB * a;
    const float4 r4 = f4(rs + t * DMAX + cq), k4 = f4(ks + sw(t, cq));
    const float4 bonus = scale4(dBv[t], f4(us + cq));
    at4(ds + t * DMAX + cq) = mul4(r4, gr[a]);
    at4(vs + t * DMAX + cq) = mul4(k4, gk[a]);
    gr[a] = fmav(bonus, k4, gr[a]);
    gk[a] = fmav(bonus, r4, gk[a]);
    at4(rs + t * DMAX + cq) = mul4(r4, qd[a]);
    at4(ks + sw(t, cq)) = mul4(k4, kd[a]);
  }
  __syncthreads();

  // 7. The blocks below the diagonal.  dr's pair terms from earlier
  //    sub-chunks in Horner form over S, h_T <- h_T tot_S + dA_TS k'_S,
  //    then dr += qd h and y += q' h; dr goes out.
  {
    float4 h[NSUB];
#pragma unroll
    for (int a = 0; a < NSUB; ++a) h[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int S = 0; S < NSUB - 1; ++S) {
      if (S > 0) {
        const float4 m = f4(tot + S * DMAX + cq);
#pragma unroll
        for (int a = S + 1; a < NSUB; ++a) h[a] = mul4(h[a], m);
      }
#pragma unroll
      for (int sl = 0; sl < SUB; ++sl) {
        const float4 kv = f4(ks + sw(SUB * S + sl, cq));
#pragma unroll
        for (int a = S + 1; a < NSUB; ++a)
          fma4(h[a], dAs[blk(a, S) + ty * BPAD + sl], kv);
      }
    }
#pragma unroll
    for (int a = 0; a < NSUB; ++a) {
      const int t = ty + SUB * a;
      if (a > 0) {
        gr[a] = fmav(qd[a], h[a], gr[a]);
        float4& y = at4(ds + t * DMAX + cq);
        y = fmav(f4(rs + t * DMAX + cq), h[a], y);
      }
      if (cols && t < L && t0 + t < p.s)
        at4(p.dr + gofs + static_cast<long long>(t0 + t) * p.g_ss + cq) =
            gr[a];
    }
  }
  //    dk's pair terms from later sub-chunks in Horner form over T from
  //    the last, h_S <- h_S tot_T + dA_TS^T q'_T; then dk += kd h and
  //    z += k' h.
  {
    float4 h[NSUB];
#pragma unroll
    for (int a = 0; a < NSUB; ++a) h[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int T = NSUB - 1; T > 0; --T) {
      if (T < NSUB - 1) {
        const float4 m = f4(tot + T * DMAX + cq);
#pragma unroll
        for (int a = 0; a < T; ++a) h[a] = mul4(h[a], m);
      }
#pragma unroll
      for (int tl = 0; tl < SUB; ++tl) {
        const float4 qv = f4(rs + (SUB * T + tl) * DMAX + cq);
#pragma unroll
        for (int a = 0; a < T; ++a)
          fma4(h[a], dAs[blk(T, a) + tl * BPAD + ty], qv);
      }
    }
#pragma unroll
    for (int a = 0; a < NSUB - 1; ++a) {
      const int t = ty + SUB * a;
      gk[a] = fmav(kd[a], h[a], gk[a]);
      float4& z = at4(vs + t * DMAX + cq);
      z = fmav(f4(ks + sw(t, cq)), h[a], z);
    }
  }
  //    A_TS = (q'_T mid) k'_S^T on columns tx + 16 b, masked, mid the
  //    decay over the sub-chunks between (tot[1], tot[2] or their product).
  {
    float ab[6];   // (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)
#pragma unroll
    for (int n = 0; n < 6; ++n) ab[n] = 0.f;
#pragma unroll 2
    for (int i = 0; i < dk; i += 4) {
      const float4 q1 = f4(rs + (ty + SUB) * DMAX + i);
      const float4 q2 = f4(rs + (ty + 2 * SUB) * DMAX + i);
      const float4 q3 = f4(rs + (ty + 3 * SUB) * DMAX + i);
      const float4 k0 = f4(ks + sw(tx, i));
      const float4 k1 = f4(ks + sw(tx + SUB, i));
      const float4 k2 = f4(ks + sw(tx + 2 * SUB, i));
      const float4 m1 = f4(tot + DMAX + i), m2 = f4(tot + 2 * DMAX + i);
      const float4 k0m = mul4(k0, m1);
      ab[0] = dot4(q1, k0, ab[0]);
      ab[1] = dot4(q2, k0m, ab[1]);
      ab[2] = dot4(q2, k1, ab[2]);
      ab[3] = dot4(q3, mul4(k0m, m2), ab[3]);
      ab[4] = dot4(q3, mul4(k1, m2), ab[4]);
      ab[5] = dot4(q3, k2, ab[5]);
    }
    int n = 0;
#pragma unroll
    for (int a = 1; a < NSUB; ++a)
#pragma unroll
      for (int b = 0; b < a; ++b, ++n) {
        const int t = ty + SUB * a, s = tx + SUB * b;
        Ss[blk(a, b) + ty * BPAD + tx] = Rs[t] == Rs[s] ? ab[n] : 0.f;
      }
  }
  __syncthreads();

  // 8. z into q''s place.  dv's pair and bonus terms: A^T dO over the
  //    blocks at and below each key's own.
#pragma unroll
  for (int a = 0; a < NSUB; ++a)
    at4(rs + (ty + SUB * a) * DMAX + cq) = f4(vs + (ty + SUB * a) * DMAX + cq);
  float4 gv[NSUB];
#pragma unroll
  for (int a = 0; a < NSUB; ++a) gv[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int T = 0; T < NSUB; ++T) {
#pragma unroll 4
    for (int tl = 0; tl < SUB; ++tl) {
      const float4 ov = f4(os + (SUB * T + tl) * DMAX + cq);
#pragma unroll
      for (int a = 0; a <= T; ++a)
        if (a < T || tl >= ty)
          fma4(gv[a], Ss[blk(T, a) + tl * BPAD + ty], ov);
    }
  }
  __syncthreads();  // A and dO are read; their regions free

  // 9. k_hat = k' (the decay of the sub-chunks after) where R == R_last,
  //    in place of k', by each owner.  v again, and S, for dS . S, in dO's
  //    place; then dS leaving the chunk, pass 1's output (zero in the last
  //    chunk, then neither awaited nor read).
  const int R_last = Rs[LMAX - 1];
#pragma unroll
  for (int a = 0; a < NSUB; ++a) {
    const int t = ty + SUB * a;
    float4& kh = at4(ks + sw(t, cq));
    kh = Rs[t] == R_last ? mul4(kh, f4(aft + a * DMAX + cq))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  stage_tile<true>(vs, vg, p.v_ss, t0, L, p.s, dk, DMAX, p.vec, tid);
  stage_tile(os, Sg, dk, 0, c > 0 ? dk : 0, dk, dk, DMAX, 1, tid);
  cp_async_commit();
  const bool leaving = c < p.nc - 1;
  if (leaving) asm volatile("griddepcontrol.wait;" ::: "memory");
  stage_tile<true>(Ss, p.dstates + hc * dk * dk, dk, 0, leaving ? dk : 0, dk,
                   dk, DMAX, 1, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 10. dk's state term v dS^T: dk out; w = k_hat (dk's state term).
  //     dv's state term k_hat dS: dv out.  dS . S over dv.  Then w into
  //     v's place.
  float4 wv[NSUB];
  {
    float xk[NSUB][4];
#pragma unroll
    for (int a = 0; a < NSUB; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) xk[a][b] = 0.f;
#pragma unroll 2
    for (int j = 0; j < dk; j += 4) {
      float4 vq[NSUB], gq[4];
#pragma unroll
      for (int a = 0; a < NSUB; ++a) vq[a] = f4(vs + sw(ty + SUB * a, j));
#pragma unroll
      for (int b = 0; b < 4; ++b) gq[b] = f4(Ss + sw(cq + b, j));
#pragma unroll
      for (int a = 0; a < NSUB; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) xk[a][b] = dot4(vq[a], gq[b], xk[a][b]);
    }
#pragma unroll
    for (int a = 0; a < NSUB; ++a) {
      const int t = ty + SUB * a;
      const float4 x = make_float4(xk[a][0], xk[a][1], xk[a][2], xk[a][3]);
      const float4 pk = Rs[t] == R_last ? mul4(kd[a], f4(aft + a * DMAX + cq))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      if (cols && t < L && t0 + t < p.s)
        at4(p.dk_ + gofs + static_cast<long long>(t0 + t) * p.g_ss + cq) =
            fmav(pk, x, gk[a]);
      wv[a] = mul4(f4(ks + sw(t, cq)), x);
    }
  }
  {
    float4 xv[NSUB];
#pragma unroll
    for (int a = 0; a < NSUB; ++a) xv[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int i = 0; i < dk; i += 4) {
      float4 kh[NSUB];
#pragma unroll
      for (int a = 0; a < NSUB; ++a) kh[a] = f4(ks + sw(ty + SUB * a, i));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 g = f4(Ss + sw(i + q, cq));
#pragma unroll
        for (int a = 0; a < NSUB; ++a) fma4(xv[a], comp(kh[a], q), g);
      }
    }
#pragma unroll
    for (int a = 0; a < NSUB; ++a) {
      const int t = ty + SUB * a;
      if (cols && t < L && t0 + t < p.s)
        at4(p.dv + gofs + static_cast<long long>(t0 + t) * p.g_ss + cq) =
            add4(gv[a], xv[a]);
    }
  }
  {
    // row i = tid / 4 of dS . S, a quarter of dv a thread
    const int i = tid / 4, j0 = (tid % 4) * (DMAX / 4);
    float acc = 0.f;
#pragma unroll
    for (int j = j0; j < j0 + DMAX / 4; j += 4)
      acc = dot4(f4(Ss + sw(i, j)), f4(os + i * DMAX + j), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (tid % 4 == 0) ddec[i] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NSUB; ++a) at4(vs + (ty + SUB * a) * DMAX + cq) = wv[a];
  __syncthreads();

  // 11. dloga_m = (the sum of y - z over t > m) - z_m + (the sum of w over
  //     s < m) + dec (dS . S).  Thread (i, T) sums its sub-chunk's y - z and
  //     w into tot and aft (read first: dec is the product of tot), then
  //     walks its rows with the partials of the other sub-chunks.
  {
    const int i = tid % DMAX, T = tid / DMAX;
    float dec = 1.f;
#pragma unroll
    for (int U = 0; U < NSUB; ++U) dec *= tot[U * DMAX + i];
    const float base = R_last == 0 ? dec * ddec[i] : 0.f;
    float pe = 0.f, pw = 0.f;
#pragma unroll
    for (int t = T * SUB; t < T * SUB + SUB; ++t) {
      pe += ds[t * DMAX + i] - rs[t * DMAX + i];
      pw += vs[t * DMAX + i];
    }
    __syncthreads();
    tot[T * DMAX + i] = pe;
    aft[T * DMAX + i] = pw;
    __syncthreads();
    float before = 0.f, after = 0.f;
    for (int U = 0; U < T; ++U) before += aft[U * DMAX + i];
    for (int U = NSUB - 1; U > T; --U) after += tot[U * DMAX + i];
    float pre[SUB];
#pragma unroll
    for (int m = 0; m < SUB; ++m) {
      pre[m] = before;
      before += vs[(T * SUB + m) * DMAX + i];
    }
#pragma unroll
    for (int m = SUB - 1; m >= 0; --m) {
      const int t = T * SUB + m;
      const float z = rs[t * DMAX + i];
      if (t < L && t0 + t < p.s && i < dk)
        p.dloga[gofs + static_cast<long long>(t0 + t) * p.g_ss + i] =
            after - z + pre[m] + base;
      after += ds[t * DMAX + i] - z;
    }
  }
  // Every CTA ends after pass 1 has ended, so whatever follows this grid on
  // the stream, or in a graph, also follows pass 1's writes even where no
  // CTA here read them.
  if (!leaving) asm volatile("griddepcontrol.wait;" ::: "memory");
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

template <int DK, int LC>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_state_kernel<DK, LC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM1_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<DK, LC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM2_BYTES);
  // all of the SM's 228 KB as shared memory, so two pass-2 CTAs fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<DK, LC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_state_kernel<DK, LC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The three passes on `st`, in order; the first non-zero cudaError_t.
template <int DK, int LC>
cudaError_t launch(const Params& p, cudaStream_t st) {
  cudaError_t err = set_attributes<DK, LC>();
  if (err != cudaSuccess) return err;
  wkv6_bwd_state_kernel<DK, LC><<<dim3((p.dk + BK - 1) / BK, p.h, p.b),
                                  THREADS, SMEM1_BYTES, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nc, p.h, p.b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM2_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_chunk_kernel<DK, LC>, p);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_du_kernel<<<p.h, DMAX, 0, st>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// Strides are in elements; r, k, v, loga and dout are (b, s, h, dk) with a
// unit last stride; dr, dk, dv and dloga share one such layout (g_*), with
// rows on 16 bytes (pointers 16-byte aligned, strides multiples of 4); u is
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
      states == nullptr || dstates == nullptr || du_part == nullptr ||
      !aligned16(dr) || !aligned16(dk_) || !aligned16(dv) ||
      !aligned16(dloga) || g_sb % 4 != 0 || g_ss % 4 != 0 || g_sh % 4 != 0)
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
  // 16-byte copies only where every staged row starts on 16 bytes
  const long long strides[] = {r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb,
                               v_ss, v_sh, a_sb, a_ss, a_sh, o_sb, o_ss,
                               o_sh};
  p.vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(loga) &&
          aligned16(dout);
  for (long long x : strides) p.vec = p.vec && x % 4 == 0;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rwkv6-3b's shapes get compile-time loop bounds and index math
  return static_cast<int>(dk == DMAX && chunk == LMAX
                              ? launch<DMAX, LMAX>(p, st)
                              : launch<0, 0>(p, st));
}

// Pass 2's resident CTAs an SM at rwkv6-3b's shapes, as the runtime
// computes them (its registers, its shared memory, the carveout); 0 on
// error.
extern "C" int wkv6_bwd_chunk_ctas_per_sm() {
  int n = 0;
  if (set_attributes<DMAX, LMAX>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_bwd_chunk_kernel<DMAX, LMAX>, THREADS, SMEM2_BYTES) !=
          cudaSuccess)
    return 0;
  return n;
}
