// Segment-aware packed flash attention, backward, for Hopper (sm_90a).
//
// The JAX package has no backward kernel: it trains by differentiating the
// jnp `segment_attention` (src/repro/models/attention.py:70).  The port's
// training forward runs the CUDA kernel of csrc/packed_attention.cu, so its
// gradient needs a kernel of its own.  Same function as the autograd of
// `ref.packed_attention_ref`: q attends to k iff seg_q == seg_k != 0 and
// (causal) k <= q by buffer index; GQA maps q head h to kv head h / (H / KH);
// rows with no valid key (every padding row) get no gradient.  The
// FlashAttention-2 formulas, from the forward's output O and its per-row
// log-sum-exp (+inf where a row has no valid key):
//   D = rowsum(dO * O),  P = exp(S scale - lse) on the mask,
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K scale,  dK = dS^T Q scale,
// with dK and dV summed over each GQA group.
//
// bfloat16 only (the training path computes in bf16), d % 16 == 0 and
// d <= 128; the columns up to D (16, 32, 64 or 128) are zero-filled in
// shared memory.  Every pointer and every batch, head and row stride is a
// multiple of 16 bytes (the wrapper checks).
//
// What bounds it on the H100: at the training shape (b 4, s 1024, 32 heads,
// 8 kv heads, d 128, documents of the data plane's coyo text lengths,
// median ~20 tokens) it moves ~170 MB (q, k, v, O, dO, lse, dq, dk, dv
// once: ~0.05 ms at 3.35 TB/s) and does 10 d FLOP per valid (q, k) pair,
// ~8 GFLOP (~0.008 ms at 989 TFLOP/s), so its floor is bytes.  The design is three launches with no atomics, so the
// gradients are bitwise deterministic:
//   (a) `delta_kernel`: D = rowsum(dO * O) in float32, one warp per row.
//   (b) `dkdv_kernel`: one CTA of 4 warps per (kv head, batch row, 64-key
//       tile); each warp owns 16 keys.  It walks the group's q heads and,
//       for each, the 64-row q tiles that pass the forward's skip rule
//       (src/repro/kernels/packed_attention.py:55-63: causal, segment-range
//       and all-padding skips), with the next live tile's Q, dO, lse, D and
//       segment ids requested by cp.async while this one is computed (two
//       stages).  It recomputes S^T = K Q^T and P^T from lse, dP^T = V dO^T
//       and dS^T, 32 queries at a time, and accumulates dV += P^T dO and
//       dK += dS^T Q in registers for the whole walk.
//   (c) `dq_kernel`: one CTA of 4 warps per (q head, batch row, 64-row q
//       tile), each warp 16 rows with their Q and dO fragments in registers;
//       it walks the live 64-key tiles (two stages of K and V by cp.async),
//       recomputes S, P, dP and dS, 32 keys at a time, and accumulates
//       dQ += dS K.
// Every product runs on the tensor cores as
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, with fragments by ldmatrix
// (.trans where the product's k dimension is a tile's rows).  P and dS are
// packed to bf16 in registers and reused as A operands.  Tiles' rows are
// padded by 16 bytes so ldmatrix reads are free of bank conflicts.  The
// skip tests are computed by every warp from the segment ids (ballots), so
// they stay uniform across the CTA without a barrier.  Outputs are staged
// through each warp's own rows of a tile and written with 16-byte stores.
//
// Left for later: wgmma, TMA and warp-specialised producers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = 4;      // 16 rows (queries or keys) per warp
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (b, h, sq), contiguous
  float* delta;      // (b, h, sq), contiguous: written by delta_kernel
  const int* q_seg;
  const int* kv_seg;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int h, kh, sq, sk, d, causal;
  // (batch, head, row) strides in elements of q, k, v, o, dout, dq, dk, dv
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  long long qseg_sb, kvseg_sb;
  float scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; a src_bytes of 0 reads nothing and zero-fills
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
// 2^x on the SFU; -inf (a row with no valid key) gives 0
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
// `ss` into shared memory rows of D + 8, by 16-byte cp.async; rows >= nrows
// and columns >= d become 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long ss, int row0, int nrows,
                                          int d, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int idx = tid; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int row = row0 + r;
    const bool in = row < nrows && c < d;
    cp_async16(s + r * (D + 8) + c, in ? g + row * ss + c : g, in ? 16 : 0);
  }
}
// `n` int32 or float32 values from g[i0 ..] into shared memory, 0 past `lim`
__device__ __forceinline__ void load_words(void* s, const void* g, int i0,
                                           int lim, int n, int tid) {
  if (tid < n) {
    const int i = i0 + tid;
    const bool in = i < lim;
    cp_async4(static_cast<int*>(s) + tid,
              in ? static_cast<const int*>(g) + i : g, in ? 4 : 0);
  }
}

// The forward's skip rule for one (q tile, kv tile) pair, as a test on the
// rows `i0 .. i0 + 63` (< lim) of `seg` against the other tile's segment-id
// range [lo, hi] (padding included): the pair is live iff hi > 0, some row
// has an id <= hi and some row an id >= max(lo, 1), which is
// max(seg_q) >= min(seg_k), max(seg_k) >= min(seg_q), max(seg_q) > 0 and
// max(seg_k) > 0.  Each warp computes it alone, so every warp gets the same
// answer with no barrier.  The causal skip is tested by the callers.
__device__ __forceinline__ bool seg_live(const int* seg, int i0, int lim,
                                        int lo, int hi, int lane) {
  if (hi <= 0) return false;
  const int lo_id = max(lo, 1);
  int n_lo = 0, n_hi = 0;
#pragma unroll
  for (int r = 0; r < 64; r += 32) {
    const int i = i0 + r + lane;
    const bool in = i < lim;
    const int sg = in ? seg[i] : 0;
    n_lo += __popc(__ballot_sync(0xffffffffu, in && sg <= hi));
    n_hi += __popc(__ballot_sync(0xffffffffu, in && sg >= lo_id));
  }
  return n_lo > 0 && n_hi > 0;
}
// The id range of rows i0 .. i0 + 63 (< lim) of `seg`, over the warp.
__device__ __forceinline__ void seg_range(const int* seg, int i0, int lim,
                                          int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < 64; r += 32) {
    const int i = i0 + r + lane;
    if (i < lim) {
      lo = min(lo, seg[i]);
      hi = max(hi, seg[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// ------------------------------------------------------- (a) D = rowsum
__global__ void __launch_bounds__(256) delta_kernel(const Params p, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % p.sq, bh = row / p.sq;
  const int ih = bh % p.h, ib = bh / p.h;
  const bf16* og = p.o + ib * p.o_sb + ih * p.o_sh + i * p.o_ss;
  const bf16* dg = p.dout + ib * p.do_sb + ih * p.do_sh + i * p.do_ss;
  float acc = 0.f;
  for (int c = 2 * lane; c < p.d; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(og + c));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dg + c));
    acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ------------------------------------------------------------ (b) dK, dV
template <int D>
constexpr int dkdv_smem_bytes() {
  // K, V; two stages of (Q, dO); two stages of lse, D and q segment ids;
  // the kv tile's segment ids
  return (2 * BK + 4 * BQ) * (D + 8) * 2 + 2 * 3 * BQ * 4 + BK * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2) dkdv_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;  // k-steps over d; n-tile pairs over d
  constexpr int DT = D / 8;   // n-tiles of dK, dV
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + BK * LD;
  bf16* QdO = Vs + BK * LD;  // stage s: Q at QdO + 2 s BQ LD, dO after it
  float* lse_s = reinterpret_cast<float*>(QdO + 4 * BQ * LD);  // 2 stages
  float* del_s = lse_s + 2 * BQ;
  int* qseg_s = reinterpret_cast<int*>(del_s + 2 * BQ);
  int* kseg_s = qseg_s + 2 * BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int ikh = blockIdx.x, ib = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * BK;
  const int group = p.h / p.kh;
  const int n_qt = (p.sq + BQ - 1) / BQ;
  // under the causal rule no q tile before the one holding query k0 is live
  const int qt0 = p.causal ? min(k0 / BQ, n_qt) : 0;
  const int nq = n_qt - qt0;
  const int n_items = group * nq;  // (q head of the group, q tile) pairs

  const int* qsg = p.q_seg + ib * p.qseg_sb;
  const int* ksg = p.kv_seg + ib * p.kvseg_sb;
  load_rows<D, BK>(Ks, p.k + ib * p.k_sb + ikh * p.k_sh, p.k_ss, k0, p.sk,
                   p.d, tid);
  load_rows<D, BK>(Vs, p.v + ib * p.v_sb + ikh * p.v_sh, p.v_ss, k0, p.sk,
                   p.d, tid);
  load_words(kseg_s, ksg, k0, p.sk, BK, tid);
  int kmin, kmax;
  seg_range(ksg, k0, p.sk, lane, kmin, kmax);

  // The first live item after `it` (n_items if none); uniform.
  auto next_item = [&](int it) -> int {
    for (++it; it < n_items; ++it) {
      const int q0 = (qt0 + it % nq) * BQ;
      const int q_last = min(q0 + BQ, p.sq) - 1;
      if (p.causal && q_last < k0) continue;
      if (seg_live(qsg, q0, p.sq, kmin, kmax, lane)) return it;
    }
    return n_items;
  };
  auto load_item = [&](int it, int st) {
    const int ih = ikh * group + it / nq, q0 = (qt0 + it % nq) * BQ;
    bf16* qs = QdO + st * 2 * BQ * LD;
    load_rows<D, BQ>(qs, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq,
                     p.d, tid);
    load_rows<D, BQ>(qs + BQ * LD, p.dout + ib * p.do_sb + ih * p.do_sh,
                     p.do_ss, q0, p.sq, p.d, tid);
    const long long row0 = (static_cast<long long>(ib) * p.h + ih) * p.sq;
    load_words(lse_s + st * BQ, p.lse + row0, q0, p.sq, BQ, tid);
    load_words(del_s + st * BQ, p.delta + row0, q0, p.sq, BQ, tid);
    load_words(qseg_s + st * BQ, qsg, q0, p.sq, BQ, tid);
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int kr0 = warp * 16 + gr, kr1 = kr0 + 8;  // this lane's two keys
  const float sl2 = p.scale * LOG2E;

  int cur = next_item(-1), rs = 0;
  if (cur < n_items) load_item(cur, 0);
  cp_async_commit();  // K, V, the kv segment ids and the first item
  while (cur < n_items) {
    __syncthreads();  // every read of the other stage is done
    const int nxt = next_item(cur);
    if (nxt < n_items) load_item(nxt, rs ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* Qs = QdO + rs * 2 * BQ * LD;
    const bf16* dOs = Qs + BQ * LD;
    const float* lse_t = lse_s + rs * BQ;
    const float* del_t = del_s + rs * BQ;
    const int* qs_t = qseg_s + rs * BQ;
    const int q0 = (qt0 + cur % nq) * BQ;
    const int ks0 = kseg_s[kr0], ks1 = kseg_s[kr1];
    const int kj0 = k0 + kr0, kj1 = k0 + kr1;

#pragma unroll 1
    for (int qb = 0; qb < BQ; qb += 32) {  // 32 queries at a time
      // S^T = K Q^T and dP^T = V dO^T: st[j][e] is (key kr0, query
      // qb + j*8 + tig*2 + e), st[j][2 + e] is key kr1
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned ka[4], va[4], bq[2][4], bd[2][4];
        const int a_off = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8;
        ldmatrix_x4(ka, Ks + a_off);
        ldmatrix_x4(va, Vs + a_off);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int b_off = (qb + jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                                LD + kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bq[jp], Qs + b_off);
          ldmatrix_x4(bd[jp], dOs + b_off);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma_bf16(st[2 * jp], ka, bq[jp][0], bq[jp][1]);
          mma_bf16(st[2 * jp + 1], ka, bq[jp][2], bq[jp][3]);
          mma_bf16(dpt[2 * jp], va, bd[jp][0], bd[jp][1]);
          mma_bf16(dpt[2 * jp + 1], va, bd[jp][2], bd[jp][3]);
        }
      }
      // P^T = exp(S^T scale - lse) on the mask; dS^T = P^T (dP^T - D);
      // both packed to bf16 A fragments (k = queries, 16 per step)
      unsigned pa[2][4], da[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float pr[2][4], dr[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int j = 2 * t + h2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = qb + j * 8 + tig * 2 + e;
            const int qi = q0 + qc, qsg_c = qs_t[qc];
            const float l2 = lse_t[qc] * LOG2E, dl = del_t[qc];
            const bool v0 =
                qsg_c == ks0 && ks0 > 0 && (!p.causal || qi >= kj0);
            const bool v1 =
                qsg_c == ks1 && ks1 > 0 && (!p.causal || qi >= kj1);
            const float p0 = v0 ? fast_exp2(fmaf(st[j][e], sl2, -l2)) : 0.f;
            const float p1 =
                v1 ? fast_exp2(fmaf(st[j][2 + e], sl2, -l2)) : 0.f;
            pr[h2][e] = p0;
            pr[h2][2 + e] = p1;
            dr[h2][e] = p0 * (dpt[j][e] - dl);
            dr[h2][2 + e] = p1 * (dpt[j][2 + e] - dl);
          }
        }
        pa[t][0] = pack_bf16x2(pr[0][0], pr[0][1]);  // key kr0, queries 0-7
        pa[t][1] = pack_bf16x2(pr[0][2], pr[0][3]);  // key kr1, queries 0-7
        pa[t][2] = pack_bf16x2(pr[1][0], pr[1][1]);  // key kr0, queries 8-15
        pa[t][3] = pack_bf16x2(pr[1][2], pr[1][3]);  // key kr1, queries 8-15
        da[t][0] = pack_bf16x2(dr[0][0], dr[0][1]);
        da[t][1] = pack_bf16x2(dr[0][2], dr[0][3]);
        da[t][2] = pack_bf16x2(dr[1][0], dr[1][1]);
        da[t][3] = pack_bf16x2(dr[1][2], dr[1][3]);
      }
      // dV += P^T dO, dK += dS^T Q: B fragments by ldmatrix.trans over the
      // query rows
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          unsigned bdo[4], bqq[4];
          const int off = (qb + t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + dp * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bdo, dOs + off);
          ldmatrix_x4_trans(bqq, Qs + off);
          mma_bf16(dv[2 * dp], pa[t], bdo[0], bdo[1]);
          mma_bf16(dv[2 * dp + 1], pa[t], bdo[2], bdo[3]);
          mma_bf16(dk[2 * dp], da[t], bqq[0], bqq[1]);
          mma_bf16(dk[2 * dp + 1], da[t], bqq[2], bqq[3]);
        }
    }
    rs ^= 1;
    cur = nxt;
  }

  // ---- dK (scaled) and dV: staged in this warp's own rows of K and V ------
  cp_async_wait<0>();
  __syncthreads();  // K, V landed even where no item was live
  bf16* dks = Ks + warp * 16 * LD;
  bf16* dvs = Vs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(dks + gr * LD + c) =
        __floats2bfloat162_rn(dk[n][0] * p.scale, dk[n][1] * p.scale);
    *reinterpret_cast<__nv_bfloat162*>(dks + (gr + 8) * LD + c) =
        __floats2bfloat162_rn(dk[n][2] * p.scale, dk[n][3] * p.scale);
    *reinterpret_cast<__nv_bfloat162*>(dvs + gr * LD + c) =
        __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dvs + (gr + 8) * LD + c) =
        __floats2bfloat162_rn(dv[n][2], dv[n][3]);
  }
  __syncwarp();
  bf16* dkg = p.dk + ib * p.dk_sb + ikh * p.dk_sh;
  bf16* dvg = p.dv + ib * p.dv_sb + ikh * p.dv_sh;
  for (int idx = lane; idx < 16 * DT; idx += 32) {
    const int r = idx / DT, c = (idx % DT) * 8;
    const int row = k0 + warp * 16 + r;
    if (row >= p.sk || c >= p.d) continue;
    *reinterpret_cast<uint4*>(dkg + row * p.dk_ss + c) =
        *reinterpret_cast<const uint4*>(dks + r * LD + c);
    *reinterpret_cast<uint4*>(dvg + row * p.dv_ss + c) =
        *reinterpret_cast<const uint4*>(dvs + r * LD + c);
  }
}

// ------------------------------------------------------------------ (c) dQ
template <int D>
constexpr int dq_smem_bytes() {
  // Q, dO; two stages of (K, V) and of the kv segment ids
  return (2 * BQ + 4 * BK) * (D + 8) * 2 + 2 * BK * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2) dq_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dOs = Qs + BQ * LD;
  bf16* KVs = dOs + BQ * LD;  // stage s: K at KVs + 2 s BK LD, V after it
  int* kseg_s = reinterpret_cast<int*>(KVs + 4 * BK * LD);  // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  // q tiles latest first: under the causal rule they have the most keys
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int ih = blockIdx.x, ib = blockIdx.y;
  const int ikh = ih / (p.h / p.kh);
  const int* qsg = p.q_seg + ib * p.qseg_sb;
  const int* ksg = p.kv_seg + ib * p.kvseg_sb;
  const bf16* kg = p.k + ib * p.k_sb + ikh * p.k_sh;
  const bf16* vg = p.v + ib * p.v_sb + ikh * p.v_sh;

  load_rows<D, BQ>(Qs, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq,
                   p.d, tid);
  load_rows<D, BQ>(dOs, p.dout + ib * p.do_sb + ih * p.do_sh, p.do_ss, q0,
                   p.sq, p.d, tid);
  cp_async_commit();
  int qmin, qmax;
  seg_range(qsg, q0, p.sq, lane, qmin, qmax);
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int n_kt = (p.sk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, q_last / BK + 1);

  auto next_live = [&](int t) -> int {  // first live kv tile after t
    for (++t; t < n_kt; ++t)
      if (seg_live(ksg, t * BK, p.sk, qmin, qmax, lane)) return t;
    return n_kt;
  };
  auto load_kv = [&](int t, int st) {
    bf16* ks = KVs + st * 2 * BK * LD;
    load_rows<D, BK>(ks, kg, p.k_ss, t * BK, p.sk, p.d, tid);
    load_rows<D, BK>(ks + BK * LD, vg, p.v_ss, t * BK, p.sk, p.d, tid);
    load_words(kseg_s + st * BK, ksg, t * BK, p.sk, BK, tid);
  };

  // this lane's two q rows: segment id, lse in log2 units, D
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const long long row0 = (static_cast<long long>(ib) * p.h + ih) * p.sq;
  const int qs0 = r0 < p.sq ? qsg[r0] : 0, qs1 = r1 < p.sq ? qsg[r1] : 0;
  const float l20 = r0 < p.sq ? p.lse[row0 + r0] * LOG2E : 0.f;
  const float l21 = r1 < p.sq ? p.lse[row0 + r1] * LOG2E : 0.f;
  const float dl0 = r0 < p.sq ? p.delta[row0 + r0] : 0.f;
  const float dl1 = r1 < p.sq ? p.delta[row0 + r1] : 0.f;
  const float sl2 = p.scale * LOG2E;

  int cur = next_live(-1), rs = 0;
  if (cur < n_kt) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();
  unsigned qf[KS][4], df[KS][4];  // this warp's 16 rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kk], Qs + off);
    ldmatrix_x4(df[kk], dOs + off);
  }
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  while (cur < n_kt) {
    __syncthreads();  // every read of the other stage is done
    const int nxt = next_live(cur);
    if (nxt < n_kt) load_kv(nxt, rs ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* Ks = KVs + rs * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    const int* ks_t = kseg_s + rs * BK;
    const int k0 = cur * BK;
#pragma unroll 1
    for (int kb = 0; kb < BK; kb += 32) {  // 32 keys at a time
      // S = Q K^T, dP = dO V^T: s[j][e] is (row r0, key kb + j*8 + tig*2 +
      // e), s[j][2 + e] is row r1
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned bk[2][4], bv[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int off = (kb + jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bk[jp], Ks + off);
          ldmatrix_x4(bv[jp], Vs + off);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma_bf16(s[2 * jp], qf[kk], bk[jp][0], bk[jp][1]);
          mma_bf16(s[2 * jp + 1], qf[kk], bk[jp][2], bk[jp][3]);
          mma_bf16(dp[2 * jp], df[kk], bv[jp][0], bv[jp][1]);
          mma_bf16(dp[2 * jp + 1], df[kk], bv[jp][2], bv[jp][3]);
        }
      }
      // dS = P (dP - D), packed to bf16 A fragments (k = keys)
      unsigned da[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float dr[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int j = 2 * t + h2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = kb + j * 8 + tig * 2 + e;
            const int kj = k0 + kc, ksg_c = ks_t[kc];
            const bool v0 =
                ksg_c == qs0 && ksg_c > 0 && (!p.causal || r0 >= kj);
            const bool v1 =
                ksg_c == qs1 && ksg_c > 0 && (!p.causal || r1 >= kj);
            const float p0 = v0 ? fast_exp2(fmaf(s[j][e], sl2, -l20)) : 0.f;
            const float p1 =
                v1 ? fast_exp2(fmaf(s[j][2 + e], sl2, -l21)) : 0.f;
            dr[h2][e] = p0 * (dp[j][e] - dl0);
            dr[h2][2 + e] = p1 * (dp[j][2 + e] - dl1);
          }
        }
        da[t][0] = pack_bf16x2(dr[0][0], dr[0][1]);  // row r0, keys 0-7
        da[t][1] = pack_bf16x2(dr[0][2], dr[0][3]);  // row r1, keys 0-7
        da[t][2] = pack_bf16x2(dr[1][0], dr[1][1]);  // row r0, keys 8-15
        da[t][3] = pack_bf16x2(dr[1][2], dr[1][3]);  // row r1, keys 8-15
      }
      // dQ += dS K: K's B fragments by ldmatrix.trans over the key rows
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int dp2 = 0; dp2 < KS; ++dp2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, Ks + (kb + t * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                                   dp2 * 16 + (lane >> 4) * 8);
          mma_bf16(dq[2 * dp2], da[t], b[0], b[1]);
          mma_bf16(dq[2 * dp2 + 1], da[t], b[2], b[3]);
        }
    }
    rs ^= 1;
    cur = nxt;
  }

  // ---- dQ (scaled): staged in this warp's own rows of Q -------------------
  cp_async_wait<0>();
  bf16* stg = Qs + warp * 16 * LD;  // read only by this warp, into qf
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(stg + gr * LD + c) =
        __floats2bfloat162_rn(dq[n][0] * p.scale, dq[n][1] * p.scale);
    *reinterpret_cast<__nv_bfloat162*>(stg + (gr + 8) * LD + c) =
        __floats2bfloat162_rn(dq[n][2] * p.scale, dq[n][3] * p.scale);
  }
  __syncwarp();
  bf16* dqg = p.dq + ib * p.dq_sb + ih * p.dq_sh;
  for (int idx = lane; idx < 16 * DT; idx += 32) {
    const int r = idx / DT, c = (idx % DT) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= p.sq || c >= p.d) continue;
    *reinterpret_cast<uint4*>(dqg + row * p.dq_ss + c) =
        *reinterpret_cast<const uint4*>(stg + r * LD + c);
  }
}

template <int D>
cudaError_t launch_d(const Params& p, int b, cudaStream_t stream) {
  constexpr int smem_kv = dkdv_smem_bytes<D>();
  constexpr int smem_q = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  const int rows = b * p.h * p.sq;
  delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.kh, b, (p.sk + BK - 1) / BK);
  dkdv_kernel<D><<<grid_kv, THREADS, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(p.h, b, (p.sq + BQ - 1) / BQ);
  dq_kernel<D><<<grid_q, THREADS, smem_q, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ptrs: q, k, v, o, dout, lse, delta, q_seg, kv_seg, dq, dk, dv.
// strides: the (batch, head, row) strides in elements of q, k, v, o, dout,
// dq, dk and dv (24), then the batch strides of q_seg and kv_seg.  q, o,
// dout, dq: (b, h, sq, d); k, v, dk, dv: (b, kh, sk, d); all bfloat16 with a
// unit last stride, 16-byte aligned pointers and strides; lse and delta
// contiguous (b, h, sq) float32; segment ids int32 (b, s) with a unit last
// stride.  d % 16 == 0, d <= 128.  Three launches on `stream`; returns the
// first cudaError_t that is not 0, or 0.
extern "C" int packed_attention_bwd_launch(
    void* const* ptrs, const long long* strides, int b, int h, int kh,
    int sq, int sk, int d, float scale, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0 || d <= 0 ||
      d > 128 || d % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(ptrs[0]);
  p.k = static_cast<const bf16*>(ptrs[1]);
  p.v = static_cast<const bf16*>(ptrs[2]);
  p.o = static_cast<const bf16*>(ptrs[3]);
  p.dout = static_cast<const bf16*>(ptrs[4]);
  p.lse = static_cast<const float*>(ptrs[5]);
  p.delta = static_cast<float*>(ptrs[6]);
  p.q_seg = static_cast<const int*>(ptrs[7]);
  p.kv_seg = static_cast<const int*>(ptrs[8]);
  p.dq = static_cast<bf16*>(ptrs[9]);
  p.dk = static_cast<bf16*>(ptrs[10]);
  p.dv = static_cast<bf16*>(ptrs[11]);
  p.h = h;
  p.kh = kh;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  long long* dst[] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,
                      &p.k_ss,  &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.o_sb,
                      &p.o_sh,  &p.o_ss,  &p.do_sb, &p.do_sh, &p.do_ss,
                      &p.dq_sb, &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh,
                      &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss, &p.qseg_sb,
                      &p.kvseg_sb};
  for (int i = 0; i < 26; ++i) *dst[i] = strides[i];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = d <= 16   ? launch_d<16>(p, b, s)
                    : d <= 32 ? launch_d<32>(p, b, s)
                    : d <= 64 ? launch_d<64>(p, b, s)
                              : launch_d<128>(p, b, s);
  return static_cast<int>(err);
}
