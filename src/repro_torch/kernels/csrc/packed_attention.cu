// Segment-aware packed flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `packed_flash_attention` / `_attn_kernel` in
// src/repro/kernels/packed_attention.py.  Same function: q attends to k iff
// seg_q == seg_k != 0 and (causal) k <= q by buffer index; online softmax in
// float32 with mask value -1e30; rows whose segment id is 0 output 0; GQA
// maps q head h to kv head h / (H / KH) without expanding K/V.
//
// Design (simple first):
//   * One block per (q tile of BQ rows, q head, batch row).  The TPU kernel's
//     sequential kv grid dimension becomes a loop inside the block, carrying
//     m, l (per row) and acc (per row and column) in float32 registers.
//   * Tile skipping as in the TPU kernel: the kv loop ends at the causal
//     diagonal, and a kv tile whose segment-id range cannot meet the q tile's
//     (or that is all padding) is skipped before its K/V are loaded.  Only the
//     tiles that the packing needs are read, so cost follows sum(l_i^2).
//   * Ragged tails are masked (no divisibility requirement); any head dim
//     d <= 128 is zero-padded to D = 64 or 128 in shared memory.
//   * Inputs are float32 or bfloat16 with arbitrary strides except a unit
//     last stride; tiles are converted to float32 in shared memory and both
//     products run as float32 FMAs on the CUDA cores (4x2 logits and 4xD/16
//     outputs per thread, float4 shared-memory reads).  Output in q's dtype.
//
// What bounds it on the H100: at the serving shapes (b=4, s=512, 32 heads,
// d=128, causal) the work is ~8.6 GFLOP against ~42 MB of q/k/v/out, so the
// card's floor is its memory (~13 us at 3.35 TB/s).  This kernel is instead
// bound by float32 FMA issue and shared-memory bandwidth, far above that
// floor.  Left for later: bf16 tensor-core products (mma.sync / wgmma) with
// K/V kept in bf16, cp.async or TMA double-buffering of the K/V tiles, and
// a backward kernel for training.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile (one warp loads its segs)
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx owns columns
constexpr int ROWS = 4;        // rows per thread (BQ / 16)
constexpr int KCOLS = BK / 16; // logit columns per thread: tx + 16 * j
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
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long qseg_sb, kvseg_sb;
  float scale;
};

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

template <typename T, int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, b);
  packed_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 64) return launch<T, 64>(p, b, stream);
  if (p.d <= 128) return launch<T, 128>(p, b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Returns the launch's cudaError_t; 0 means it was accepted.
extern "C" int packed_attention_launch(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, void* out, int b, int h, int kh, int sq, int sk,
    int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long qseg_sb, long long kvseg_sb, float scale, int causal,
    int dtype, void* stream) {
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
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.qseg_sb = qseg_sb;
  p.kvseg_sb = kvseg_sb;
  p.scale = scale;
  if (b <= 0 || sq <= 0 || sk <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_d<float>(p, b, s)
                  : dtype == 1 ? launch_d<__nv_bfloat16>(p, b, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
