// Segment-aware packed flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `packed_flash_attention` / `_attn_kernel` in
// src/repro/kernels/packed_attention.py.  Same function: q attends to k iff
// seg_q == seg_k != 0 and (causal) k <= q by buffer index; online softmax in
// float32 with mask value -1e30; rows whose segment id is 0 output 0; GQA
// maps q head h to kv head h / (H / KH) without expanding K/V.
//
// Two instantiations behind one entry point, chosen by dtype:
//
// bfloat16 (`tc::packed_attention_tc_kernel`, the serving path).  What
// bounds it on the H100: at the serving shape (b 4, s 512, 32 heads, 8 kv
// heads, d 128, causal, one segment per row) the function moves
// 41,959,424 B of q/k/v/out/segment ids (0.0125 ms at 3.35 TB/s) and does
// 8.61 GFLOP (0.0087 ms at 989 TFLOP/s of bf16 tensor cores), so its floor
// is bytes.  The design, FlashAttention-2 shaped with `mma.sync`:
//   * One CTA of 4 warps per (64-row q tile, q head, batch row); each warp
//     owns 16 q rows.  The q tile is the slowest grid dimension, latest
//     first, so every causally heavy CTA starts in the first wave.
//   * Both products run on the tensor cores as
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (the fp32 FMA design ran
//     at ~17 TFLOP/s).  The q tile is loaded once with 16-byte cp.async and
//     held as A fragments in registers (ldmatrix) for the whole kv loop.
//   * K/V tiles of 64 keys stay in bf16 in shared memory (no widening to
//     fp32: 88,848 B per CTA at d 128, two CTAs per SM), with rows padded by
//     16 bytes so ldmatrix reads are free of bank conflicts.  They are
//     double-buffered: the next live tile is requested before this one is
//     computed, each K or V row as one Hopper bulk copy
//     (cp.async.bulk, one thread per row) whose bytes complete on the
//     stage's mbarrier, and the tile's segment ids by cp.async.  Per-thread
//     16-byte cp.async of the tiles was slower on the H100 (the address
//     arithmetic and the 32 copy instructions per thread per tile).  Two
//     __syncthreads per live tile.  Each k-step's fragments are
//     all requested (ldmatrix) before its mma's, so their latency overlaps.
//   * The online softmax runs in fp32 on the accumulator fragments (a row
//     lives in a lane quad: two shuffles for its max).  P is packed to bf16
//     in registers and reused as the A operand of P.V (V's B fragments by
//     ldmatrix.trans), with no shared-memory round trip.
//   * Masks come from fragment coordinates; p is zeroed where an element is
//     invalid, so a row with no valid key in a live tile adds nothing.  A
//     tile wholly below the diagonal whose q and kv segment ids are all one
//     id > 0 skips the per-element mask.
//   * Tile skipping as in the TPU kernel, uniform across the CTA: the kv
//     loop ends at the causal diagonal, and a kv tile whose segment-id range
//     cannot meet the q tile's (or that is all padding) is skipped before
//     its K/V are requested.  The skip flags of all the q tile's kv tiles
//     are computed up front, one warp per tile (ballots), into shared
//     memory, so no segment-id load sits in the kv loop.
//   * Ragged tails are masked (rows past sk are zeroed); d is zero-padded
//     to 32, 64, 80 or 128 in shared memory.  Inputs whose pointers or row
//     strides are not 16-byte aligned, or d % 8 != 0, take a scalar load
//     path.
//   * The output tile is staged through the q tile's shared memory and
//     written with 16-byte stores.
//
// float32 (`fp32::packed_attention_kernel`).  TF32 or bf16 products could not
// hold float32's tolerance, so fp32 inputs keep the CUDA-core design: tiles
// converted to float32 in shared memory, both products as float32 FMAs
// (4x2 logits and 4xD/16 outputs per thread), BK 32, the same skip rule.
//
// The bfloat16 kernel also writes each row's log-sum-exp when the caller
// passes an `lse` buffer (the autograd path).  That write is a template
// flag, so the instantiation the serve path runs (a null `lse`) is the
// kernel it ran before; the float32 kernel writes none, as it has no
// backward.  The backward kernel is csrc/packed_attention_bwd.cu.
//
// Left for later: wgmma with TMA and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float NEG_INF = -1e30f;
// the log-sum-exp of a row with no valid key (ref.LSE_EMPTY): +inf, so the
// backward's exp(s - lse) is 0 there
__device__ __forceinline__ float lse_empty() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype/to do
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;
  const int* kv_seg;
  void* out;
  int h, kh, sq, sk, d, causal;
  int vec;  // every pointer and row stride 16-byte aligned, d % 8 == 0
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long qseg_sb, kvseg_sb;
  float scale;
};

// ============================================================ float32 ====
namespace fp32 {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile (one warp loads its segs)
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx owns columns
constexpr int ROWS = 4;        // rows per thread (BQ / 16)
constexpr int KCOLS = BK / 16; // logit columns per thread: tx + 16 * j

// Row reductions over the 16 lanes (same ty) that share a row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  // Q (BQ x LD), K and V (BK x LD), P (BQ x LDP) in float32; then the
  // q tile's and kv tile's segment ids.
  return ((BQ + 2 * BK) * (D + 4) + BQ * (BK + 4)) * 4 + (BQ + BK) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
packed_attention_kernel(const Params p) {
  constexpr int LD = D + 4;    // row stride: 16-byte aligned, and rows
                               // tx, tx+1.. land 4 banks apart for float4
  constexpr int LDP = BK + 4;
  constexpr int NC = D / 64;   // float4 output column groups per thread

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  int* qseg_s = reinterpret_cast<int*>(Ps + BQ * LDP);
  int* kseg_s = qseg_s + BQ;
  __shared__ int tile_live;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikh = ih / (p.h / p.kh);

  const T* qg = static_cast<const T*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + ib * p.k_sb + ikh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + ib * p.v_sb + ikh * p.v_sh;
  const int* qsg = p.q_seg + ib * p.qseg_sb;
  const int* ksg = p.kv_seg + ib * p.kvseg_sb;

  // ---- the q tile and its segment ids ------------------------------------
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    Qs[r * LD + c] =
        (qi < p.sq && c < p.d) ? to_f32(qg[qi * p.q_ss + c]) : 0.f;
  }
  if (tid < BQ) {
    const int qi = q0 + tid;
    qseg_s[tid] = qi < p.sq ? qsg[qi] : 0;
  }
  __syncthreads();

  const int q_rows = min(BQ, p.sq - q0);
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < q_rows; ++r) {
    qmin = min(qmin, qseg_s[r]);
    qmax = max(qmax, qseg_s[r]);
  }

  int qrow[ROWS], qseg[ROWS];
  float m_i[ROWS], l_i[ROWS], acc[ROWS][NC * 4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    qrow[r] = q0 + ty * ROWS + r;
    qseg[r] = qseg_s[ty * ROWS + r];
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NC * 4; ++e) acc[r][e] = 0.f;
  }

  int n_kv_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) n_kv_tiles = min(n_kv_tiles, (q0 + q_rows - 1) / BK + 1);

  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every read of the previous tile's K, V, P is done

    // ---- skip test on the kv tile's segment ids (warp 0) -----------------
    if (tid < 32) {
      const int kj = k0 + tid;
      const bool in = kj < p.sk;
      const int s = in ? ksg[kj] : 0;
      kseg_s[tid] = s;
      int kmin = in ? s : INT_MAX, kmax = in ? s : INT_MIN;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
      }
      if (tid == 0)
        tile_live = qmax >= kmin && kmax >= qmin && qmax > 0 && kmax > 0;
    }
    __syncthreads();
    if (!tile_live) continue;  // uniform across the block

    // ---- K and V tiles, as float32 ---------------------------------------
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < p.sk && c < p.d;
      Ks[r * LD + c] = in ? to_f32(kg[kj * p.k_ss + c]) : 0.f;
      Vs[r * LD + c] = in ? to_f32(vg[kj * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // ---- logits: rows ty*4 + r, columns tx + 16*j ------------------------
    float s[ROWS][KCOLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[r][j] = 0.f;
    for (int c = 0; c < p.d; c += 4) {  // columns past d are zero
      float4 qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        qv[r] = *reinterpret_cast<const float4*>(
            &Qs[(ty * ROWS + r) * LD + c]);
#pragma unroll
      for (int j = 0; j < KCOLS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) {
          float a = s[r][j];
          a = fmaf(qv[r].x, kv[j].x, a);
          a = fmaf(qv[r].y, kv[j].y, a);
          a = fmaf(qv[r].z, kv[j].z, a);
          a = fmaf(qv[r].w, kv[j].w, a);
          s[r][j] = a;
        }
    }

    // ---- mask and online softmax -----------------------------------------
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bool valid[KCOLS];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int col = tx + 16 * j;
        const int ks = kseg_s[col];
        valid[j] = ks == qseg[r] && ks > 0 && (!p.causal || qrow[r] >= k0 + col);
        s[r][j] = valid[j] ? s[r][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m_i[r], mx);
      const float corr = expf(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float pj = valid[j] ? expf(s[r][j] - m_new) : 0.f;
        Ps[(ty * ROWS + r) * LDP + tx + 16 * j] = pj;
        rs += pj;
      }
      rs = row_sum(rs);
      l_i[r] = l_i[r] * corr + rs;
#pragma unroll
      for (int e = 0; e < NC * 4; ++e) acc[r][e] *= corr;
      m_i[r] = m_new;
    }
    __syncthreads();  // P is complete

    // ---- acc += P V: columns g*64 + tx*4 + {0..3} -------------------------
    for (int j = 0; j < BK; j += 4) {
      float pr[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(
            &Ps[(ty * ROWS + r) * LDP + j]);
        pr[r][0] = pv.x;
        pr[r][1] = pv.y;
        pr[r][2] = pv.z;
        pr[r][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * LD + g * 64 + tx * 4]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][g * 4 + 0] = fmaf(pr[r][jj], vv.x, acc[r][g * 4 + 0]);
            acc[r][g * 4 + 1] = fmaf(pr[r][jj], vv.y, acc[r][g * 4 + 1]);
            acc[r][g * 4 + 2] = fmaf(pr[r][jj], vv.z, acc[r][g * 4 + 2]);
            acc[r][g * 4 + 3] = fmaf(pr[r][jj], vv.w, acc[r][g * 4 + 3]);
          }
        }
    }
  }

  // ---- normalise, zero padding rows, store in q's dtype ------------------
  T* og = static_cast<T*>(p.out) + ib * p.o_sb + ih * p.o_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (qrow[r] >= p.sq) continue;
    const float denom = fmaxf(l_i[r], 1e-20f);
    const bool keep = qseg[r] > 0;
    T* orow = og + qrow[r] * p.o_ss;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < p.d)
          orow[col] = from_f32<T>(keep ? acc[r][g * 4 + e] / denom : 0.f);
      }
  }
}

}  // namespace fp32

// ================================================ bfloat16, tensor cores ====
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per CTA, 16 per warp
constexpr int BK = 64;        // keys per kv tile
constexpr int STAGES = 2;     // kv tiles in shared memory (STAGES - 1 ahead)
constexpr int MIN_CTAS = 2;   // resident CTAs per SM the registers allow
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAXT = 1024;    // kv tiles whose skip flags are held at once
constexpr int BAR_U4 = (STAGES * 8 + 15) / 16;  // mbarriers, in 16 B units

template <int D>
constexpr int smem_bytes() {
  // the stages' mbarriers; Q, then STAGES stages of (K, V), bf16 rows of
  // D + 8; then the kv tiles' segment ids (STAGES of them), the q tile's,
  // and the skip flags.
  return 16 * BAR_U4 + (BQ + 2 * STAGES * BK) * (D + 8) * 2 +
         (STAGES * BK + BQ) * 4 + MAXT;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; the bytes past `src_bytes` (here 0 or 16) are
// zero-filled, and a src_bytes of 0 reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Hopper bulk copy of `bytes` (a multiple of 16) global -> shared, whose
// completion is counted on the mbarrier `bar` in bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// the one arrival of a phase, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// ldmatrix stays volatile with a memory clobber, so it is never moved
// across a barrier; mma touches registers only and is left free, so the
// compiler can start the next fragments' ldmatrix before this mma's result.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x on the SFU (ex2.approx, ~2 ulp); inputs here are <= 0, and tiny
// results flush to 0, which only drops weights below 2^-126
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows row0 .. row0 + ROWS - 1 of a (rows, d) bf16 matrix with row stride
// `ss` into shared memory rows of D + 8; rows >= nrows and columns >= d
// become 0.  `vec`: 16-byte cp.async (completion through the group
// bookkeeping); else scalar loads and stores, complete at the next barrier.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long ss, int row0, int nrows,
                                          int d, bool vec, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int idx = tid; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int row = row0 + r;
    bf16* dst = s + r * (D + 8) + c;
    if (vec) {
      const bool in = row < nrows && c < d;
      cp_async16(dst, in ? g + row * ss + c : g, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (row < nrows && c + e < d) ? g[row * ss + c + e]
                                            : __float2bfloat16(0.f);
    }
  }
}

// LSE: write each row's log-sum-exp to `lse` (b, h, sq); else `lse` is
// unused and the kernel is the serve path's.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
packed_attention_tc_kernel(const Params p, float* __restrict__ lse) {
  constexpr int LD = D + 8;   // padded row: 8 ldmatrix rows hit 8 distinct
                              // 16-byte bank groups for every D here
  constexpr int KS = D / 16;  // k-steps of Q K^T; n-tile pairs of P V
  constexpr int NT = BK / 8;  // n-tiles of S (8 keys each)
  constexpr int DT = D / 8;   // n-tiles of O
  extern __shared__ uint4 smem_u4[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_u4);
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4 + BAR_U4);
  bf16* KVs = Qs + BQ * LD;   // stage s: K at + 2 s BK LD, V BK LD after it
  int* kseg_s = reinterpret_cast<int*>(KVs + 2 * STAGES * BK * LD);
  int* qseg_s = kseg_s + STAGES * BK;
  unsigned char* flags = reinterpret_cast<unsigned char*>(qseg_s + BQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;  // fragment row, column pair
  // q tiles are the slowest grid dimension, latest first: the causally
  // heaviest CTAs of every (head, batch row) start in the first wave
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int ih = blockIdx.x, ib = blockIdx.y;
  const int ikh = ih / (p.h / p.kh);
  const bool vec = p.vec;

  const bf16* qg = static_cast<const bf16*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + ib * p.k_sb + ikh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + ib * p.v_sb + ikh * p.v_sh;
  const int* qsg = p.q_seg + ib * p.qseg_sb;
  const int* ksg = p.kv_seg + ib * p.kvseg_sb;

  load_tile<D, BQ>(Qs, qg, p.q_ss, q0, p.sq, p.d, vec, tid);
  cp_async_commit();
  if (vec) {
    // K/V rows come by bulk copies of d columns: the columns d .. D - 1 of
    // every stage are zeroed once and never written again
    if (tid == 0)
      for (int st = 0; st < STAGES; ++st) mbar_init(bars + st);
    if (p.d < D)
      for (int idx = tid; idx < 2 * STAGES * BK * (D - p.d); idx += THREADS)
        KVs[(idx / (D - p.d)) * LD + p.d + idx % (D - p.d)] =
            __float2bfloat16(0.f);
  }

  // the q tile's segment-id range over its rows < sq (padding included, as
  // in the TPU kernel's test), and whether it is one segment > 0 throughout
  const int q_rows = min(BQ, p.sq - q0);
  if (tid < BQ) qseg_s[tid] = tid < q_rows ? qsg[q0 + tid] : 0;
  int qmin = INT_MAX, qmax = INT_MIN;
  if (tid < q_rows) qmin = qmax = qsg[q0 + tid];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
  int* red = reinterpret_cast<int*>(flags);  // before the flags are filled
  if (lane == 0) {
    red[2 * warp] = qmin;
    red[2 * warp + 1] = qmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    qmin = min(qmin, red[2 * w]);
    qmax = max(qmax, red[2 * w + 1]);
  }
  const bool q_one = q_rows == BQ && qmin == qmax && qmin > 0;

  int n_kv = (p.sk + BK - 1) / BK;
  if (p.causal) n_kv = min(n_kv, (q0 + q_rows - 1) / BK + 1);

  // Skip flags of kv tiles win0 .. win0 + MAXT - 1, one warp per tile:
  // bit 0 live (the tile's segment-id range meets the q tile's and is not
  // all padding), bit 1 full (no per-element mask needed).  Called by every
  // thread at the same point; the barriers fence the old window's readers.
  int win0 = 0;
  auto fill_flags = [&]() {
    __syncthreads();
    const int lo_id = max(qmin, 1);
#pragma unroll 2
    for (int t = win0 + warp; t < min(n_kv, win0 + MAXT); t += WARPS) {
      int n_lo = 0, n_hi = 0;
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 32) {
        const int kj = t * BK + k0 + lane;
        const bool in = kj < p.sk;
        const int sg = in ? ksg[kj] : 0;
        n_lo += __popc(__ballot_sync(0xffffffffu, in && sg <= qmax));
        n_hi += __popc(__ballot_sync(0xffffffffu, in && sg >= lo_id));
      }
      if (lane == 0)
        flags[t - win0] = (qmax > 0 && n_lo > 0 && n_hi > 0) |
                          (q_one && n_lo == BK && n_hi == BK &&
                           (!p.causal || t * BK + BK - 1 <= q0)) << 1;
    }
    __syncthreads();
  };
  // The first live kv tile at or after t (n_kv if none), from the flags;
  // uniform across the CTA.  `full`: the tile needs no per-element mask.
  auto next_live = [&](int t, bool& full) -> int {
    for (; t < n_kv; ++t) {
      if (t < win0 || t >= win0 + MAXT) {
        win0 = t;
        fill_flags();
      }
      const int f = flags[t - win0];
      if (f & 1) {
        full = f & 2;
        return t;
      }
    }
    full = false;
    return n_kv;
  };
  // K, V and the segment ids of kv tile t into `stage`.  On the 16-byte
  // path each K or V row is one bulk copy (one thread per row, completion
  // counted in bytes on the stage's mbarrier), and rows past sk are zeroed;
  // else scalar loads.  The segment ids come by cp.async.
  auto load_kv = [&](int t, int stage) {
    bf16* ks = KVs + stage * 2 * BK * LD;
    if (vec) {
      const int rows = min(BK, p.sk - t * BK);
      if (tid == 0) mbar_arrive_expect(bars + stage, 2 * rows * p.d * 2);
      for (int i = tid; i < 2 * BK; i += THREADS) {
        const int r = i % BK, kv = i / BK;
        bf16* dst = ks + (kv * BK + r) * LD;
        if (r < rows) {
          const int row = t * BK + r;
          bulk_copy(dst, kv ? vg + row * p.v_ss : kg + row * p.k_ss,
                    p.d * 2, bars + stage);
        } else {
          for (int c = 0; c < p.d; ++c) dst[c] = __float2bfloat16(0.f);
        }
      }
    } else {
      load_tile<D, BK>(ks, kg, p.k_ss, t * BK, p.sk, p.d, vec, tid);
      load_tile<D, BK>(ks + BK * LD, vg, p.v_ss, t * BK, p.sk, p.d, vec,
                       tid);
    }
    if (tid < BK) {
      const int kj = t * BK + tid;
      const bool in = kj < p.sk;  // past sk: segment 0, i.e. padding
      cp_async4(kseg_s + stage * BK + tid, in ? ksg + kj : ksg, in ? 4 : 0);
    }
  };

  // request the first STAGES - 1 live tiles (empty groups past the last)
  __syncthreads();  // the mbarriers are initialised
  fill_flags();
  bool unused;
  int ahead = -1, ws = 0;  // the last tile requested; the stage it took
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    ahead = next_live(ahead + 1, unused);
    if (ahead < n_kv) load_kv(ahead, i);
    cp_async_commit();
  }
  ws = STAGES - 1;
  cp_async_wait<STAGES - 1>();  // the q tile
  __syncthreads();

  // this warp's 16 q rows as A fragments, for the whole kv loop
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;  // this lane's two rows
  const int qs0 = qseg_s[warp * 16 + gr], qs1 = qseg_s[warp * 16 + gr + 8];

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max in raw logit units, and this lane's part of the row sums
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * 1.4426950408889634f;  // to log2 units

  bool cur_full;
  int cur = next_live(0, cur_full), rs = 0;
  unsigned parity = 0;  // bit s: the phase of stage s's mbarrier to wait for
  while (cur < n_kv) {
    __syncthreads();  // every read of stage ws (the last tile's) is done
    ahead = next_live(ahead + 1, unused);
    if (ahead < n_kv) load_kv(ahead, ws);
    cp_async_commit();  // an empty group where nothing was requested
    ws = ws + 1 == STAGES ? 0 : ws + 1;
    cp_async_wait<STAGES - 1>();  // this tile's segment ids have landed
    if (vec) {                    // and its K/V rows
      mbar_wait(bars + rs, (parity >> rs) & 1);
      parity ^= 1u << rs;
    }
    __syncthreads();

    const bf16* Ks = KVs + rs * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    const int* ks_s = kseg_s + rs * BK;
    const int k0 = cur * BK;

    // ---- S = Q K^T: n-tile j holds keys j*8 .. j*8+7 ---------------------
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned b[NT / 2][4];  // this k-step's K fragments, all in flight
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp)
        ldmatrix_x4(b[jp], Ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        mma_bf16(s[2 * jp], qf[kk], b[jp][0], b[jp][1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[jp][2], b[jp][3]);
      }
    }

    // ---- masks from fragment coordinates: s[j][e] is (r0, col), s[j][2+e]
    //      is (r1, col), col = j*8 + tig*2 + e.  Invalid logits become
    //      -1e30, and their p is zeroed below. ---------------------------------
    bool v[NT][4];
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (cur_full) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = true;
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 8 + tig * 2 + e;
          const int ks = ks_s[cl], c = k0 + cl;
          v[j][e] = ks == qs0 && ks > 0 && (!p.causal || r0 >= c);
          v[j][2 + e] = ks == qs1 && ks > 0 && (!p.causal || r1 >= c);
          if (!v[j][e]) s[j][e] = NEG_INF;
          if (!v[j][2 + e]) s[j][2 + e] = NEG_INF;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // a row lives in a lane quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = fast_exp2((m0 - mn0) * sl2);
    const float c1 = fast_exp2((m1 - mn1) * sl2);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // ---- p = exp2(s sl2 - m sl2), zeroed where invalid (a row with no
    //      valid key yet has m = -1e30 and would get exp2(0) = 1), packed
    //      to bf16 A fragments of P V -------------------------------------------
    const float b0 = -mn0 * sl2, b1 = -mn1 * sl2;
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      float pr[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = 2 * t + h2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pr[h2][e] = v[j][e] ? fast_exp2(fmaf(s[j][e], sl2, b0)) : 0.f;
          pr[h2][2 + e] =
              v[j][2 + e] ? fast_exp2(fmaf(s[j][2 + e], sl2, b1)) : 0.f;
          l0 += pr[h2][e];
          l1 += pr[h2][2 + e];
        }
      }
      pa[t][0] = pack_bf16x2(pr[0][0], pr[0][1]);  // row r0, keys 0-7
      pa[t][1] = pack_bf16x2(pr[0][2], pr[0][3]);  // row r1, keys 0-7
      pa[t][2] = pack_bf16x2(pr[1][0], pr[1][1]);  // row r0, keys 8-15
      pa[t][3] = pack_bf16x2(pr[1][2], pr[1][3]);  // row r1, keys 8-15
    }

    // ---- O += P V -----------------------------------------------------------
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int dp0 = 0; dp0 < KS; dp0 += 4) {  // V fragments four at a time
        unsigned b[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (dp0 + i < KS)
            ldmatrix_x4_trans(b[i], Vs + (t * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * LD +
                                        (dp0 + i) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (dp0 + i < KS) {
            mma_bf16(o[2 * (dp0 + i)], pa[t], b[i][0], b[i][1]);
            mma_bf16(o[2 * (dp0 + i) + 1], pa[t], b[i][2], b[i][3]);
          }
      }

    rs = rs + 1 == STAGES ? 0 : rs + 1;
    cur = next_live(cur + 1, cur_full);
  }

  // ---- normalise, zero padding rows, stage in this warp's own q rows -----
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = qs0 > 0 ? 1.f / fmaxf(l0, 1e-20f) : 0.f;
  const float inv1 = qs1 > 0 ? 1.f / fmaxf(l1, 1e-20f) : 0.f;
  if (LSE && tig == 0) {  // m0, m1 are in raw logit units
    float* lg = lse + (static_cast<long long>(ib) * p.h + ih) * p.sq;
    if (r0 < p.sq) lg[r0] = l0 > 0.f ? m0 * p.scale + logf(l0) : lse_empty();
    if (r1 < p.sq) lg[r1] = l1 > 0.f ? m1 * p.scale + logf(l1) : lse_empty();
  }
  bf16* stg = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stg + gr * LD + n * 8 + tig * 2) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(stg + (gr + 8) * LD + n * 8 +
                                       tig * 2) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.out) + ib * p.o_sb + ih * p.o_sh;
  for (int idx = lane; idx < 16 * DT; idx += 32) {
    const int r = idx / DT, c = (idx % DT) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= p.sq || c >= p.d) continue;
    bf16* dst = og + row * p.o_ss + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(stg + r * LD + c);
    } else {
      for (int e = 0; e < 8 && c + e < p.d; ++e) dst[e] = stg[r * LD + c + e];
    }
  }
}

}  // namespace tc

template <int D>
cudaError_t launch_fp32(const Params& p, int b, cudaStream_t stream) {
  constexpr int smem = fp32::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fp32::packed_attention_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + fp32::BQ - 1) / fp32::BQ, p.h, b);
  fp32::packed_attention_kernel<float, D>
      <<<grid, fp32::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32_d(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 64) return launch_fp32<64>(p, b, stream);
  if (p.d <= 128) return launch_fp32<128>(p, b, stream);
  return cudaErrorInvalidValue;
}

template <int D, bool LSE>
cudaError_t launch_tc(const Params& p, float* lse, int b,
                      cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes<D>();
  const cudaError_t attr = cudaFuncSetAttribute(
      tc::packed_attention_tc_kernel<D, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.h, b, (p.sq + tc::BQ - 1) / tc::BQ);
  tc::packed_attention_tc_kernel<D, LSE>
      <<<grid, tc::THREADS, smem, stream>>>(p, lse);
  return cudaGetLastError();
}

template <bool LSE>
cudaError_t launch_tc_d(const Params& p, float* lse, int b,
                        cudaStream_t stream) {
  if (p.d <= 32) return launch_tc<32, LSE>(p, lse, b, stream);
  if (p.d <= 64) return launch_tc<64, LSE>(p, lse, b, stream);
  if (p.d <= 80) return launch_tc<80, LSE>(p, lse, b, stream);
  if (p.d <= 128) return launch_tc<128, LSE>(p, lse, b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  lse: null,
// or (bfloat16 only) a contiguous (b, h, sq) float32 buffer that receives
// each row's log-sum-exp of its masked, scaled logits (+inf where the row
// has no valid key), for the backward kernel.  vec: the
// caller has checked that every pointer and row stride (in bytes) is a
// multiple of 16 and d % 8 == 0 (the bfloat16 kernel then loads and stores
// 16 bytes at a time).  Returns the launch's cudaError_t; 0 means it was
// accepted.
extern "C" int packed_attention_launch(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, void* out, void* lse, int b, int h, int kh, int sq,
    int sk, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss,
    long long qseg_sb, long long kvseg_sb, float scale, int causal,
    int dtype, int vec, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.out = out;
  p.h = h;
  p.kh = kh;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.vec = vec;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.qseg_sb = qseg_sb;
  p.kvseg_sb = kvseg_sb;
  p.scale = scale;
  if (b <= 0 || sq <= 0 || sk <= 0 || h % kh != 0 ||
      (lse != nullptr && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lg = static_cast<float*>(lse);
  cudaError_t err = dtype == 0   ? launch_fp32_d(p, b, s)
                  : dtype != 1   ? cudaErrorInvalidValue
                  : lg != nullptr ? launch_tc_d<true>(p, lg, b, s)
                                  : launch_tc_d<false>(p, nullptr, b, s);
  return static_cast<int>(err);
}
