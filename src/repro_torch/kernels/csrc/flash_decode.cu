// Flash-decode: one query token per sequence against a KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/flash_decode.py.  Same function: out[b, h] is softmax
// attention of q[b, h] over cache positions < cache_len[b] of kv head
// h / (H / KH), in float32 with mask value -1e30, written in q's dtype.
//
// What bounds it on the H100: the bytes of K and V.  At the serving shape
// (b 4, 32 heads, 8 kv heads, d 128, 544 positions of a float32 cache) the
// call moves 17,891,344 B, 0.0053 ms at 3.35 TB/s, against ~1 FLOP per
// byte.  So the design is about keeping enough bytes in flight and keeping
// the per-position work off the latency chain:
//   * Split-S (flash-decoding) over a grid of (n_split, kv heads x head
//     chunks, b) CTAs of 4 warps.  The wrapper picks the fewest positions
//     per CTA that keep the grid in one wave of at most three CTAs per SM
//     (288 CTAs at the serving shape, two 8-row tiles per warp).  Each CTA
//     serves up to G q heads of one GQA group, so every K/V row it reads
//     serves them all.
//   * Each warp walks tiles of 8 cache rows.  A tile's K and V rows come in
//     with 16-byte cp.async into the warp's own shared-memory ring (one row
//     per warp instruction for a float32 cache, two for bfloat16): 8 KB a
//     tile for float32.  Where a warp has more than one tile the ring has
//     two stages and the next tile is requested before this one's math, so
//     at the serving shape all of a call's bytes are requested at once.
//     Positions >= cache_len are never read (zero-filled instead).
//   * Per tile: a row is held by 16 lanes of 8 consecutive head-dim
//     elements, and the two half-warps take the even and odd rows.  The
//     G x 4 partial dots of a half-warp are reduced over its 16 lanes as
//     one batch of independent butterflies (4 steps, not 5 over 8 rows),
//     so the shuffle latency is paid once per tile; then one max (over
//     both halves) and one rescale of acc per tile and head.  The halves'
//     acc are summed in the CTA merge.
//   * One launch per call.  The combine is fused: each CTA merges its warps
//     and writes its (m, l, acc) partial; the last CTA of a (b, kv head,
//     head chunk) group to arrive (__threadfence + atomicAdd on the group's
//     counter) merges the n_split partials in one pass, writes the output
//     and resets the counter to 0, so the next call and a CUDA-graph replay
//     start clean.
//   * q and the cache have independent dtypes (float32 or bfloat16) and
//     arbitrary strides except a unit last stride, so the kernel reads one
//     layer's slice of the model cache (layers, b, S, kh, hd) in place.
//     Caches whose pointers or row strides are not 16-byte aligned take a
//     scalar load path.
//   * A shard of a cache split over its sequence (the KV-sequence-parallel
//     decode of src/repro/models/attention.py) asks for its partial result:
//     given an lse pointer, the last CTA of a group also writes each head's
//     log-sum-exp (natural log; NEG_INF where no position is live) and the
//     output stays float32, so the shards' (out, lse) pairs merge without a
//     rounding.  Without one, nothing else changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TP = 8;          // cache rows per warp tile
constexpr int DMAX = 128;      // head dim
// In the math a row is held by 16 lanes of 8 elements; the two half-warps
// (row groups) take the even and the odd rows of a tile.
constexpr int RG = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  return __float2bfloat16(x);
}

// eight consecutive elements from shared memory, as float32
__device__ __forceinline__ void lds8(const float* s, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void lds8(const __nv_bfloat16* s, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  void* out;
  float* lse;       // (b, h) or null
  float* part_ml;   // (groups, G, n_split, 2): m (log2 units), l
  float* part_acc;  // (groups, G, n_split, DMAX)
  int* counter;     // (groups,), 0 between calls
  int h, kh, S, d, group, n_gchunks, split_len, n_split, stages, vec;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
  float scale;
};

template <typename TC>
constexpr int ring_bytes(int stages) {  // all warps' K/V tiles
  return WARPS * stages * 2 * TP * DMAX * static_cast<int>(sizeof(TC));
}
template <int G>
constexpr int merge_bytes() {  // the row groups' acc, for the CTA merge
  return WARPS * RG * G * DMAX * 4;
}

// TO: the output's type, q's (TQ) or float32 where the lse is asked for
template <typename TQ, typename TC, typename TO, int G>
__global__ void __launch_bounds__(THREADS, G <= 4 ? 3 : 2)
flash_decode_kernel(const Params p) {
  constexpr int VE = 16 / sizeof(TC);   // elements per 16-byte chunk
  constexpr int CH = DMAX / VE;         // chunks per row
  extern __shared__ uint4 smem_u4[];
  __shared__ float w_m[WARPS * RG][G], w_l[WARPS * RG][G];
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int ikh = blockIdx.y / p.n_gchunks, gc = blockIdx.y % p.n_gchunks;
  const int ib = blockIdx.z;
  const int n_g = min(G, p.group - gc * G);
  const int head0 = ikh * p.group + gc * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 4, e0 = (lane & 15) * 8;  // row group, elements
  const bool vec = p.vec;

  const int len = min(p.cache_len[ib], p.S);
  const int s_begin = split * p.split_len;
  const int s_end = min(s_begin + p.split_len, len);

  const TC* kg = static_cast<const TC*>(p.k) + ib * p.k_sb + ikh * p.k_sh;
  const TC* vg = static_cast<const TC*>(p.v) + ib * p.v_sb + ikh * p.v_sh;
  TC* ring = reinterpret_cast<TC*>(smem_u4) +
             warp * p.stages * 2 * TP * DMAX;  // this warp's stages

  // rows pos0 .. pos0 + TP - 1 of K and V into stage `st`
  auto load = [&](int pos0, int st) {
    TC* ks = ring + st * 2 * TP * DMAX;
    TC* vs = ks + TP * DMAX;
#pragma unroll
    for (int idx = lane; idx < TP * CH; idx += 32) {
      const int r = idx / CH, c = (idx % CH) * VE;
      const int pos = pos0 + r;
      if (vec) {
        const bool in = pos < s_end && c < p.d;
        cp_async16(ks + r * DMAX + c, in ? kg + pos * p.k_ss + c : kg,
                   in ? 16 : 0);
        cp_async16(vs + r * DMAX + c, in ? vg + pos * p.v_ss + c : vg,
                   in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const bool in = pos < s_end && c + e < p.d;
          ks[r * DMAX + c + e] = in ? kg[pos * p.k_ss + c + e]
                                    : from_f32<TC>(0.f);
          vs[r * DMAX + c + e] = in ? vg[pos * p.v_ss + c + e]
                                    : from_f32<TC>(0.f);
        }
      }
    }
  };

  // this warp's tiles start at s_begin + (warp + WARPS j) TP
  const int first = s_begin + warp * TP;
  const int n_t = first < s_end ? (s_end - first + WARPS * TP - 1) /
                                      (WARPS * TP) : 0;
  if (n_t > 0) load(first, 0);
  cp_async_commit();

  // q (while the first tile is in flight), prescaled so the dots come out
  // in log2 units
  float q[G][8];
  const TQ* qg = static_cast<const TQ*>(p.q) + ib * p.q_sb;
  const float qscale = p.scale * LOG2E;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = e0 + e;
      q[g][e] = g < n_g && c < p.d
          ? to_f32(qg[(head0 + g) * p.q_sh + c]) * qscale : 0.f;
    }

  // m is the warp's (both row groups'); l and acc this row group's part
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int j = 0; j < n_t; ++j) {
    const int pos0 = first + j * WARPS * TP;
    int st = 0;
    if (p.stages == 2) {
      if (j + 1 < n_t) load(pos0 + WARPS * TP, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      st = j & 1;
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const TC* ks = ring + st * 2 * TP * DMAX;
    const TC* vs = ks + TP * DMAX;

    // ---- dots of this row group's rows 2 i + rg with every head, reduced
    //      over the 16 lanes of a row in one batch of butterflies ----------
    constexpr int NR = TP / RG;
    float lg[G][NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float kx[8];
      lds8(ks + (RG * i + rg) * DMAX + e0, kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = q[g][0] * kx[0];
#pragma unroll
        for (int e = 1; e < 8; ++e) d = fmaf(q[g][e], kx[e], d);
        lg[g][i] = d;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < NR; ++i)
          lg[g][i] += __shfl_xor_sync(0xffffffffu, lg[g][i], off);

    // ---- one max (over both row groups) and one rescale per tile and head;
    //      lg becomes p ------------------------------------------------------
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = NEG_INF;
#pragma unroll
      for (int i = 0; i < NR; ++i)
        if (pos0 + RG * i + rg < s_end) mt = fmaxf(mt, lg[g][i]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float mn = fmaxf(m[g], mt);
      const float corr = exp2f(m[g] - mn);
      m[g] = mn;
      float ls = 0.f;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        lg[g][i] = pos0 + RG * i + rg < s_end ? exp2f(lg[g][i] - mn) : 0.f;
        ls += lg[g][i];
      }
      l[g] = fmaf(l[g], corr, ls);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float vx[8];
      lds8(vs + (RG * i + rg) * DMAX + e0, vx);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g][e] = fmaf(lg[g][i], vx[e], acc[g][e]);
    }
    __syncwarp();  // every lane is done with this stage before it refills
    if (p.stages == 1 && j + 1 < n_t) {
      load(pos0 + WARPS * TP, 0);
      cp_async_commit();
    }
  }

  // ---- merge the warps' row groups: one thread per head-dim element -----
  constexpr int NS = WARPS * RG;  // partials in the CTA
  const int src = warp * RG + rg;
  if ((lane & 15) == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      w_m[src][g] = m[g];
      w_l[src][g] = l[g];
    }
  }
  __syncthreads();  // every warp is done with its ring
  float* w_acc = reinterpret_cast<float*>(smem_u4);  // [NS][G][DMAX]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* dst = w_acc + (src * G + g) * DMAX + e0;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
  }
  __syncthreads();

  const int e = threadIdx.x;  // THREADS == DMAX
  const int grp = (ib * p.kh + ikh) * p.n_gchunks + gc;
  for (int g = 0; g < n_g; ++g) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NS; ++w) mx = fmaxf(mx, w_m[w][g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NS; ++w) {
      const float f = exp2f(w_m[w][g] - mx);
      ls = fmaf(w_l[w][g], f, ls);
      a = fmaf(w_acc[(w * G + g) * DMAX + e], f, a);
    }
    const long long row =
        (static_cast<long long>(grp) * G + g) * p.n_split + split;
    if (e == 0) {
      p.part_ml[2 * row] = mx;
      p.part_ml[2 * row + 1] = ls;
    }
    p.part_acc[row * DMAX + e] = a;
  }

  // ---- the last CTA of the group merges the n_split partials -------------
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(p.counter + grp, 1) == p.n_split - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // one warp per head; each lane merges the n_split partials of its 4
  // head-dim elements
  TO* og = static_cast<TO*>(p.out) + ib * p.o_sb;
  for (int g = warp; g < n_g; g += WARPS) {
    const long long row0 = (static_cast<long long>(grp) * G + g) * p.n_split;
    // one pass, rescaling as the maximum grows, so every split's loads can
    // be in flight together
    float mx = NEG_INF, ls = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = 0; i < p.n_split; ++i) {
      const float mi = __ldcg(p.part_ml + 2 * (row0 + i));
      const float li = __ldcg(p.part_ml + 2 * (row0 + i) + 1);
      const float4 ai = __ldcg(reinterpret_cast<const float4*>(
          p.part_acc + (row0 + i) * DMAX) + lane);
      const float mn = fmaxf(mx, mi);
      const float c_old = exp2f(mx - mn), c_new = exp2f(mi - mn);
      mx = mn;
      ls = fmaf(ls, c_old, li * c_new);
      a[0] = fmaf(a[0], c_old, ai.x * c_new);
      a[1] = fmaf(a[1], c_old, ai.y * c_new);
      a[2] = fmaf(a[2], c_old, ai.z * c_new);
      a[3] = fmaf(a[3], c_old, ai.w * c_new);
    }
    const float inv = 1.f / fmaxf(ls, 1e-20f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (lane * 4 + e < p.d)
        og[(head0 + g) * p.o_sh + lane * 4 + e] = from_f32<TO>(a[e] * inv);
    if (p.lse != nullptr && lane == 0)
      p.lse[ib * p.h + head0 + g] = ls > 0.f ? mx * LN2 + logf(ls) : NEG_INF;
  }
  if (threadIdx.x == 0) p.counter[grp] = 0;  // ready for the next call
}

template <typename TQ, typename TC, typename TO, int G>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int max_smem = ring_bytes<TC>(2) > merge_bytes<G>()
                               ? ring_bytes<TC>(2) : merge_bytes<G>();
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TC, TO, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (attr != cudaSuccess) return attr;
  const int ring = ring_bytes<TC>(p.stages);
  const int smem = ring > merge_bytes<G>() ? ring : merge_bytes<G>();
  const dim3 grid(p.n_split, p.kh * p.n_gchunks, b);
  flash_decode_kernel<TQ, TC, TO, G><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TC, typename TO>
cudaError_t launch_g(const Params& p, int b, int g, cudaStream_t stream) {
  switch (g) {
    case 1: return launch<TQ, TC, TO, 1>(p, b, stream);
    case 2: return launch<TQ, TC, TO, 2>(p, b, stream);
    case 4: return launch<TQ, TC, TO, 4>(p, b, stream);
    case 8: return launch<TQ, TC, TO, 8>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the output in q's type, or in float32 beside the lse
template <typename TQ, typename TC>
cudaError_t launch_o(const Params& p, int b, int g, cudaStream_t stream) {
  return p.lse != nullptr ? launch_g<TQ, TC, float>(p, b, g, stream)
                          : launch_g<TQ, TC, TQ>(p, b, g, stream);
}

}  // namespace

// q_dtype / c_dtype: 0 = float32, 1 = bfloat16; out has q's dtype, or is
// float32 where lse (float32 (b, h), natural log) is not null.
// g: q heads per CTA (1, 2, 4 or 8); n_gchunks = ceil((h / kh) / g).
// part_ml, part_acc: float32 scratch of b * kh * n_gchunks * g * n_split
// times 2 and 128; counter: int32 of b * kh * n_gchunks, zero before the
// first call (the kernel leaves it zero).  vec: the caches' pointers and
// row strides are 16-byte aligned and d is a whole number of 16-byte
// chunks.  One kernel launch; returns its cudaError_t (0: accepted).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, void* lse, void* part_ml, void* part_acc, void* counter, int b, int h,
    int kh, int S, int d, int g, int split_len, int n_split, int stages,
    int vec, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, float scale, int q_dtype, int c_dtype,
    void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || d <= 0 || d > DMAX ||
      split_len <= 0 || n_split <= 0 || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.cache_len = static_cast<const int*>(cache_len);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.counter = static_cast<int*>(counter);
  p.h = h;
  p.kh = kh;
  p.S = S;
  p.d = d;
  p.group = h / kh;
  p.n_gchunks = (p.group + g - 1) / g;
  p.split_len = split_len;
  p.n_split = n_split;
  p.stages = stages;
  p.vec = vec;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && c_dtype == 0) err = launch_o<float, float>(p, b, g, s);
  if (q_dtype == 0 && c_dtype == 1)
    err = launch_o<float, __nv_bfloat16>(p, b, g, s);
  if (q_dtype == 1 && c_dtype == 0)
    err = launch_o<__nv_bfloat16, float>(p, b, g, s);
  if (q_dtype == 1 && c_dtype == 1)
    err = launch_o<__nv_bfloat16, __nv_bfloat16>(p, b, g, s);
  return static_cast<int>(err);
}
