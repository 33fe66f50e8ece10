// Chunked WKV6 (the RWKV6 linear-attention recurrence), forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `wkv6_forward` / `_wkv_kernel` in
// src/repro/kernels/wkv6.py.  Same function, per (batch, head):
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(exp(loga_t)) S_{t-1} + k_t^T v_t,    S zeroed at resets,
// in the chunked form of src/repro/models/rwkv.py: within a chunk of L
// tokens, cw is the running sum of loga and R the running count of resets;
// a pair (t, s) interacts iff R_t == R_s, with weight exp(cw_{t-1} - cw_s),
// and every exponent is a decay sum over a causal range, so <= 0: nothing
// overflows and no rescaling is needed.  Resets are counts, never a penalty
// folded into the float32 cumsum.  Also writes the final state, which the
// JAX path (`wkv6_chunked(return_state=True)`) returns and prefill needs.
//
// Design (simple first):
//   * One block per (b, h).  It walks the chunks in order with the (dk, dv)
//     state resident in shared memory; the Pallas kernel's sequential grid
//     dim becomes this loop.
//   * Per chunk: stage r, k, v, loga (rows of dk floats, read by strides, so
//     the model's (b, s, h, dk) tensors need no transpose); a column scan
//     turns loga into cw; one warp counts resets with ballots; then
//       A[t][s] = sum_i r[t,i] k[s,i] exp(cw[t-1,i] - cw[s,i])   (s < t),
//       A[t][t] = sum_i r[t,i] u[i] k[t,i]                       (the bonus)
//     one (t, s) pair per thread, accumulated over i in a register: the
//     Pallas body's (L, L, dk) float32 tensor (1 MiB) is never formed.
//     Then o = (r * exp(cw_{t-1})) S + A v and
//     S <- diag(exp(cw_last)) S + (k * exp(cw_last - cw_s))^T v, each thread
//     owning four output columns (float4 reads of S and v).
//   * Tokens past s (the ragged tail) read as r = k = v = loga = 0 with no
//     reset, so they add nothing to o or to the final state.
//   * float32 throughout, with expf (not __expf), to hold 5e-5 against the
//     sequential oracle.
//
// What bounds it on the H100: at rwkv6-3b serving shapes (b=4, h=40, s=512,
// dk=64) the inputs and outputs are ~108 MB (~0.032 ms at 3.35 TB/s) and the
// arithmetic ~2.5 G operations, an expf counted as one (~0.037 ms at 67
// TFLOP/s float32), so bytes and operations are close; chip_smoke.py counts
// both from the run's inputs.  This first version is bound by neither:
// 160 blocks on 132 SMs, each running its chunks in sequence with shared-
// memory reads in every inner loop.  Left for later: a parallel pass over
// (b, h, chunk) for the A and k_hat^T v terms with only the state carry
// sequential, tensor-core products, and cp.async staging of the next chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps; two blocks fit on one SM
constexpr int LMAX = 64;      // chunk length
constexpr int DMAX = 64;      // head size, dk = dv
constexpr int PAD = DMAX + 1; // row stride of tiles read down a column
constexpr int APAD = LMAX + 1;

// Shared memory, in floats: S (DMAX x DMAX) and v (LMAX x DMAX) first, so
// their float4 reads are aligned; then r, k (LMAX x PAD), cw with a zero
// first row ((LMAX + 1) x PAD), A (LMAX x APAD), u (DMAX), R (LMAX ints).
constexpr int SMEM_FLOATS = DMAX * DMAX + LMAX * DMAX + 2 * LMAX * PAD +
                            (LMAX + 1) * PAD + LMAX * APAD + DMAX;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4 + LMAX * 4;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* loga;
  const float* u;
  const void* reset;  // (b, s) uint8 or int32
  float* out;         // (b, s, h, dk)
  float* state;       // (b, h, dk, dk) contiguous, or null
  int h, s, dk, chunk, rst_bytes;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long a_sb, a_ss, a_sh;
  long long o_sb, o_ss, o_sh;
  long long u_sh, rst_sb;
};

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 x) {
  acc.x += a * x.x;
  acc.y += a * x.y;
  acc.z += a * x.z;
  acc.w += a * x.w;
}

__global__ void __launch_bounds__(THREADS, 2) wkv6_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);  // (dk, DMAX)
  float* vs = Ss + DMAX * DMAX;                  // (L, DMAX)
  float* rs = vs + LMAX * DMAX;                  // (L, PAD): r, then r_q
  float* ks = rs + LMAX * PAD;                   // (L, PAD): k, then k_hat
  float* cwx = ks + LMAX * PAD;                  // row t + 1: cw[t]; 0: 0
  float* As = cwx + (LMAX + 1) * PAD;            // (L, APAD), s <= t
  float* us = As + LMAX * APAD;                  // (dk)
  int* Rs = reinterpret_cast<int*>(us + DMAX);   // (L): flags, then counts

  const int ih = blockIdx.x, ib = blockIdx.y, tid = threadIdx.x;
  const int dk = p.dk, dk4 = dk / 4, L = p.chunk;
  const float* rg = p.r + ib * p.r_sb + ih * p.r_sh;
  const float* kg = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vg = p.v + ib * p.v_sb + ih * p.v_sh;
  const float* ag = p.loga + ib * p.a_sb + ih * p.a_sh;
  float* og = p.out + ib * p.o_sb + ih * p.o_sh;

  for (int e = tid; e < dk * DMAX; e += THREADS) Ss[e] = 0.f;
  for (int i = tid; i < dk; i += THREADS) {
    us[i] = p.u[ih * p.u_sh + i];
    cwx[i] = 0.f;
  }

  const int n_chunks = (p.s + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    // 1. Stage the chunk.  Tokens past s: r = k = v = loga = 0, no reset.
    for (int e = tid; e < L * dk; e += THREADS) {
      const int t = e / dk, i = e - t * dk;
      const long long tt = t0 + t;
      const bool in = tt < p.s;
      rs[t * PAD + i] = in ? rg[tt * p.r_ss + i] : 0.f;
      ks[t * PAD + i] = in ? kg[tt * p.k_ss + i] : 0.f;
      vs[t * DMAX + i] = in ? vg[tt * p.v_ss + i] : 0.f;
      cwx[(t + 1) * PAD + i] = in ? ag[tt * p.a_ss + i] : 0.f;
    }
    if (tid < L) {
      int flag = 0;
      if (t0 + tid < p.s) {
        const long long off = ib * p.rst_sb + t0 + tid;
        flag = p.rst_bytes == 1
                   ? static_cast<const uint8_t*>(p.reset)[off] != 0
                   : static_cast<const int*>(p.reset)[off] != 0;
      }
      Rs[tid] = flag;
    }
    __syncthreads();

    // 2. cw = running sum of loga down each column (threads < dk); R =
    //    running count of resets (the last warp, by ballots).
    if (tid < dk) {
      float acc = 0.f;
      for (int t = 1; t <= L; ++t) {
        acc += cwx[t * PAD + tid];
        cwx[t * PAD + tid] = acc;
      }
    }
    if (tid >= THREADS - 32) {
      const int lane = tid & 31;
      const bool f0 = lane < L && Rs[lane] != 0;
      const bool f1 = lane + 32 < L && Rs[lane + 32] != 0;
      const unsigned m0 = __ballot_sync(0xffffffffu, f0);
      const unsigned m1 = __ballot_sync(0xffffffffu, f1);
      const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes <= lane
      if (lane < L) Rs[lane] = __popc(m0 & upto);
      if (lane + 32 < L) Rs[lane + 32] = __popc(m0) + __popc(m1 & upto);
    }
    __syncthreads();

    // 3. A[t][s], s <= t, one pair per thread; pair index pi = t(t+1)/2 + s.
    const int n_pairs = L * (L + 1) / 2;
    for (int pi = tid; pi < n_pairs; pi += THREADS) {
      int t = static_cast<int>((sqrtf(8.f * pi + 1.f) - 1.f) * 0.5f);
      while (t * (t + 1) / 2 > pi) --t;
      while ((t + 1) * (t + 2) / 2 <= pi) ++t;
      const int s = pi - t * (t + 1) / 2;
      const float* rt = rs + t * PAD;
      const float* ksr = ks + s * PAD;
      float acc = 0.f;
      if (s == t) {
        for (int i = 0; i < dk; ++i) acc += rt[i] * us[i] * ksr[i];
      } else if (Rs[t] == Rs[s]) {
        const float* cwm1_t = cwx + t * PAD;      // cw[t - 1]
        const float* cw_s = cwx + (s + 1) * PAD;  // cw[s]
        for (int i = 0; i < dk; ++i)
          acc += rt[i] * ksr[i] * expf(fminf(cwm1_t[i] - cw_s[i], 0.f));
      }
      As[t * APAD + s] = acc;
    }
    __syncthreads();

    // 4. r_q = r * exp(cw[t-1]) while no reset has come in the chunk (the
    //    query of the carried state); k_hat = k * exp(cw_last - cw_s) while
    //    no reset follows s (its weight in the next state).
    const int R_last = Rs[L - 1];
    for (int e = tid; e < L * dk; e += THREADS) {
      const int t = e / dk, i = e - t * dk;
      const float rq = Rs[t] == 0
          ? rs[t * PAD + i] * expf(fminf(cwx[t * PAD + i], 0.f)) : 0.f;
      const float kh = Rs[t] == R_last
          ? ks[t * PAD + i] *
                expf(fminf(cwx[L * PAD + i] - cwx[(t + 1) * PAD + i], 0.f))
          : 0.f;
      rs[t * PAD + i] = rq;
      ks[t * PAD + i] = kh;
    }
    __syncthreads();

    // 5. o[t][j..j+3] = r_q[t] S[:, j..j+3] + sum_{s <= t} A[t][s] v[s][j..].
    for (int e = tid; e < L * dk4; e += THREADS) {
      const int t = e / dk4, j = (e - t * dk4) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* rq = rs + t * PAD;
      for (int i = 0; i < dk; ++i)
        fma4(acc, rq[i], *reinterpret_cast<const float4*>(Ss + i * DMAX + j));
      const float* at = As + t * APAD;
      for (int s = 0; s <= t; ++s)
        fma4(acc, at[s], *reinterpret_cast<const float4*>(vs + s * DMAX + j));
      if (t0 + t < p.s) {
        float* o = og + static_cast<long long>(t0 + t) * p.o_ss + j;
        o[0] = acc.x;
        o[1] = acc.y;
        o[2] = acc.z;
        o[3] = acc.w;
      }
    }
    __syncthreads();

    // 6. S[i][j..j+3] <- dec_i S[i][j..] + sum_s k_hat[s][i] v[s][j..]; the
    //    carried state survives only a chunk with no reset.
    for (int e = tid; e < dk * dk4; e += THREADS) {
      const int i = e / dk4, j = (e - i * dk4) * 4;
      const float dec = R_last == 0 ? expf(fminf(cwx[L * PAD + i], 0.f)) : 0.f;
      float4* si = reinterpret_cast<float4*>(Ss + i * DMAX + j);
      const float4 old = *si;
      float4 acc = make_float4(old.x * dec, old.y * dec, old.z * dec,
                               old.w * dec);
      for (int s = 0; s < L; ++s)
        fma4(acc, ks[s * PAD + i],
             *reinterpret_cast<const float4*>(vs + s * DMAX + j));
      *si = acc;
    }
    __syncthreads();
  }

  if (p.state != nullptr) {
    float* sg = p.state + (static_cast<long long>(ib) * p.h + ih) * dk * dk;
    for (int e = tid; e < dk * dk; e += THREADS) {
      const int i = e / dk, j = e - i * dk;
      sg[e] = Ss[i * DMAX + j];
    }
  }
}

}  // namespace

// Strides are in elements; r, k, v, loga and out are (b, s, h, dk) with a
// unit last stride, u is (h, dk), reset (b, s) of rst_bytes (1 or 4) each.
// state may be null.  Returns the launch's cudaError_t; 0 means accepted.
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const void* loga,
    const void* u, const void* reset, void* out, void* state, int b, int h,
    int s, int dk, int chunk, int rst_bytes, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long a_sb,
    long long a_ss, long long a_sh, long long o_sb, long long o_ss,
    long long o_sh, long long u_sh, long long rst_sb, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || dk < 4 || dk > DMAX || dk % 4 != 0 ||
      chunk < 1 || chunk > LMAX || (rst_bytes != 1 && rst_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.loga = static_cast<const float*>(loga);
  p.u = static_cast<const float*>(u);
  p.reset = reset;
  p.out = static_cast<float*>(out);
  p.state = static_cast<float*>(state);
  p.h = h;
  p.s = s;
  p.dk = dk;
  p.chunk = chunk;
  p.rst_bytes = rst_bytes;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.a_sb = a_sb; p.a_ss = a_ss; p.a_sh = a_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.u_sh = u_sh;
  p.rst_sb = rst_sb;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b);
  wkv6_kernel<<<grid, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
