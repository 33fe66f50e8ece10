// Flash-decode: one query token per sequence against a KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/flash_decode.py.  Same function: out[b, h] is softmax
// attention of q[b, h] over cache positions < cache_len[b] of kv head
// h / (H / KH), in float32 with mask value -1e30, written in q's dtype.
//
// Design (simple first):
//   * Split-S (flash-decoding).  b x kv_heads is 32 blocks for qwen3-8b at
//     batch 4, which would leave most of the 132 SMs idle, so the cache
//     positions are also split into chunks of `split_len`: grid =
//     (n_split, kv_heads x head-chunks, b).  Each block handles the q heads
//     of one GQA group (up to 8 at a time) against its chunk, so every K/V
//     row it reads serves the whole group.  A second small launch combines
//     the blocks' (m, l, acc) partials, which the wrapper allocates.
//   * Inside a block, each of the 4 warps walks every 4th position of the
//     chunk; a lane holds head-dim elements lane + 32 t (t < 4, d <= 128),
//     so each K/V row is read once, coalesced.  Positions >= cache_len are
//     never read.  The warps' partials are merged in shared memory.
//   * q and the cache have independent dtypes (float32 or bfloat16) and
//     arbitrary strides except a unit last stride, so the kernel reads one
//     layer's slice of the model cache (layers, b, S, kh, hd) in place.
//
// What bounds it on the H100: the bytes of K and V up to cache_len (a few
// MB per layer at serving shapes, ~1 FLOP per byte), i.e. memory bandwidth;
// at these sizes a launch costs about as much as the data.  Left for later:
// wider (16-byte) loads, a bf16 cache, and fusing the combine step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;       // q heads per block (one GQA group, chunked)
constexpr int DMAX = 128;     // head dim: a lane holds lane + 32 t, t < 4
constexpr int PER_LANE = DMAX / 32;
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  void* out;
  float* part_m;    // (b, h, n_split)
  float* part_l;    // (b, h, n_split)
  float* part_acc;  // (b, h, n_split, d)
  int h, kh, S, d, group, n_gchunks, split_len, n_split;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
  float scale;
};

template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const Params p) {
  __shared__ float q_s[GMAX][DMAX];
  __shared__ float w_m[WARPS][GMAX];
  __shared__ float w_l[WARPS][GMAX];
  __shared__ float w_acc[WARPS][GMAX][DMAX];

  const int split = blockIdx.x;
  const int ikh = blockIdx.y / p.n_gchunks;
  const int g0 = (blockIdx.y % p.n_gchunks) * GMAX;
  const int ib = blockIdx.z;
  const int n_g = min(GMAX, p.group - g0);
  const int head0 = ikh * p.group + g0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = min(p.cache_len[ib], p.S);
  const int s_begin = split * p.split_len;
  const int s_end = min(s_begin + p.split_len, len);

  const TQ* qg = static_cast<const TQ*>(p.q) + ib * p.q_sb;
  for (int idx = threadIdx.x; idx < GMAX * DMAX; idx += THREADS) {
    const int g = idx / DMAX, e = idx % DMAX;
    q_s[g][e] = (g < n_g && e < p.d)
        ? to_f32(qg[(head0 + g) * p.q_sh + e]) : 0.f;
  }
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][PER_LANE];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) acc[g][t] = 0.f;
  }

  const TC* kg = static_cast<const TC*>(p.k) + ib * p.k_sb + ikh * p.k_sh;
  const TC* vg = static_cast<const TC*>(p.v) + ib * p.v_sb + ikh * p.v_sh;
  for (int s = s_begin + warp; s < s_end; s += WARPS) {
    float kv[PER_LANE], vv[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int e = lane + 32 * t;
      kv[t] = e < p.d ? to_f32(kg[s * p.k_ss + e]) : 0.f;
      vv[t] = e < p.d ? to_f32(vg[s * p.v_ss + e]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= n_g) break;  // uniform across the block
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t)
        dot = fmaf(q_s[g][lane + 32 * t], kv[t], dot);
      const float logit = warp_sum(dot) * p.scale;
      const float m_new = fmaxf(m[g], logit);
      const float corr = expf(m[g] - m_new);
      const float pj = expf(logit - m_new);
      l[g] = l[g] * corr + pj;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t)
        acc[g][t] = fmaf(pj, vv[t], acc[g][t] * corr);
      m[g] = m_new;
    }
  }

  // ---- merge the warps' partials; one thread per head-dim element -------
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t)
      w_acc[warp][g][lane + 32 * t] = acc[g][t];
  __syncthreads();

  const int e = threadIdx.x;  // THREADS == DMAX
  for (int g = 0; g < n_g; ++g) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, w_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(w_m[w][g] - mx);
      lsum = fmaf(w_l[w][g], f, lsum);
      a = fmaf(w_acc[w][g][e], f, a);
    }
    const long long row =
        (static_cast<long long>(ib) * p.h + head0 + g) * p.n_split + split;
    if (e == 0) {
      p.part_m[row] = mx;
      p.part_l[row] = lsum;
    }
    if (e < p.d) p.part_acc[row * p.d + e] = a;
  }
}

template <typename TQ>
__global__ void __launch_bounds__(DMAX)
flash_decode_combine_kernel(const Params p) {
  const int bh = blockIdx.x;  // ib * h + ih
  const int ib = bh / p.h, ih = bh % p.h;
  const int e = threadIdx.x;
  const long long base = static_cast<long long>(bh) * p.n_split;
  const float* pm = p.part_m + base;
  const float* pl = p.part_l + base;
  const float* pa = p.part_acc + base * p.d;
  float mx = NEG_INF;
  for (int i = 0; i < p.n_split; ++i) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < p.n_split; ++i) {
    const float f = expf(pm[i] - mx);
    lsum = fmaf(pl[i], f, lsum);
    if (e < p.d) a = fmaf(pa[static_cast<long long>(i) * p.d + e], f, a);
  }
  if (e < p.d) {
    TQ* og = static_cast<TQ*>(p.out) + ib * p.o_sb + ih * p.o_sh;
    og[e] = from_f32<TQ>(a / fmaxf(lsum, 1e-20f));
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const dim3 grid(p.n_split, p.kh * p.n_gchunks, b);
  flash_decode_split_kernel<TQ, TC><<<grid, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<TQ><<<b * p.h, DMAX, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q_dtype / c_dtype: 0 = float32, 1 = bfloat16; out has q's dtype.
// Returns the launches' cudaError_t; 0 means both were accepted.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, void* part_m, void* part_l, void* part_acc, int b, int h,
    int kh, int S, int d, int split_len, int n_split, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, float scale, int q_dtype, int c_dtype, void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || d <= 0 || d > DMAX ||
      split_len <= 0 || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.cache_len = static_cast<const int*>(cache_len);
  p.out = out;
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.h = h;
  p.kh = kh;
  p.S = S;
  p.d = d;
  p.group = h / kh;
  p.n_gchunks = (p.group + GMAX - 1) / GMAX;
  p.split_len = split_len;
  p.n_split = n_split;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && c_dtype == 0) err = launch<float, float>(p, b, s);
  if (q_dtype == 0 && c_dtype == 1)
    err = launch<float, __nv_bfloat16>(p, b, s);
  if (q_dtype == 1 && c_dtype == 0)
    err = launch<__nv_bfloat16, float>(p, b, s);
  if (q_dtype == 1 && c_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, b, s);
  return static_cast<int>(err);
}
