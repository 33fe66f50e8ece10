// Segment-aware packed flash attention, backward, for Hopper (sm_90a).
//
// The JAX package has no backward kernel: it trains by differentiating the
// jnp `segment_attention` (src/repro/models/attention.py:70).  This is the
// backward of the port's forward kernel, csrc/packed_attention.cu, the port
// of the Pallas `packed_flash_attention` (src/repro/kernels/
// packed_attention.py:122).  Same function as the autograd of
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
// d <= 128, sq and sk at most 65536.  Every pointer and every batch, head
// and row stride is a multiple of 16 bytes (the wrapper checks).
//
// What bounds it on the H100: at the training shape (b 4, s 1024, 32 heads,
// 8 kv heads, d 128, documents of the data plane's coyo text lengths,
// median ~20 tokens) it must move 168,296,448 bytes (q, k, v, O, dO, lse,
// dq, dk, dv once: 0.0502 ms at 3.35 TB/s) and do 10 d FLOP per valid
// (q, k) pair, 8.08 GFLOP (0.0082 ms at 989 TFLOP/s), so its floor is
// bytes.  Two launches, no atomics, so the gradients are bitwise
// deterministic:
//   (a) `dq_kernel`, one CTA per (q head, batch row, 64-row q tile), first:
//       D = rowsum(dO * O) in float32 for its own rows, from the dO tile it
//       loads anyway and one read of O, written to the `delta` scratch
//       while the first key tile's products run; then S = Q K^T,
//       dP = dO V^T and dQ += dS K over the live 64-key tiles.
//   (b) `dkdv_kernel`, one CTA per (kv head, batch row, 64-key tile),
//       launched after it on the same stream with programmatic stream
//       serialisation: its liveness scan and its K, V loads run while the
//       last dQ CTAs finish, and its producer waits (griddepcontrol.wait)
//       before it reads the first D.  It walks the group's q heads and,
//       for each, the live 64-row q tiles (an item): S^T = K Q^T,
//       dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
// Liveness is found once per CTA, by its producer warpgroup, before any
// product: the candidate tiles' segment ids are requested at once (32
// tiles, 2048 ids, 16 a thread) into shared memory, one lane of a warp
// takes one candidate and tests the forward's skip rule (src/repro/kernels/
// packed_attention.py:55-63: causal, segment-range and all-padding skips),
// and a ballot with a prefix count packs the live ones into the CTA's list.
// The dK/dV CTA walks that one list for every q head of its group.
//
// Warp roles.  Warpgroup 0 gives registers away (setmaxnreg) and its first
// warp is the producer: one lane issues TMA loads of 64-row x 64-column
// boxes in the 128-byte-swizzled layout, whose bytes complete on a stage's
// mbarrier, while the 32 lanes bring the stage's per-row words (lse, D,
// segment ids) by 4-byte cp.async that arrive on the same mbarrier
// (cp.async.mbarrier.arrive.noinc).  The consumer warpgroups take the
// registers and do every product on wgmma.mma_async: S and dP (m64n64k16,
// both operands in shared memory through descriptors, K-major), and dV,
// dK, dQ with P or dS converted to bf16 in registers as the A operand and
// the B tile read through the transpose bit (m64n64k16 per 64-column
// block).  The resident pair of tiles (Q and dO, or K and V) is loaded
// once; the streamed pair (K and V, or Q and dO) comes through a ring of
// two stages with full and empty mbarriers, so the next tile's loads
// overlap this tile's products.
//   dQ: 256 threads (__launch_bounds__(256, 2): 128 registers a thread at
//       launch, two CTAs an SM), producer 24, one consumer warpgroup 232;
//       ~99.8 KB of shared memory at d 128.
//   dK/dV: 384 threads (__launch_bounds__(384, 1): 168 at launch, one CTA
//       an SM), producer 40, two consumer warpgroups of 232 that take the
//       items in turn, each with its own ring of two stages and its own dK
//       and dV in registers for the whole walk; at the end each writes one
//       of its partial sums to shared memory and adds the other's (a fixed
//       order); ~166.1 KB of shared memory at d 128.
// Tiles at d 128: 16 KB.  Outputs are staged through each warp's own rows
// of a free tile and written with 16-byte stores.  Rows past sq or sk and
// columns past d are zero-filled by TMA and never written back.
// ptxas -v (CUDA 12.9, sm_90a), d 128: dq_kernel 128 registers at launch,
// dkdv_kernel 168, no spills; d 64 the same.  The setmaxnreg split needs
// exactly those counts (otherwise setmaxnreg.inc waits for registers that
// never come free), so the launch asks the runtime for each kernel's count
// and refuses to launch on any other.  A wait on an mbarrier that has not
// completed after ~2^32 cycles traps instead of hanging the card.
// On request each CTA writes the number of live tiles it found into
// `live` (per CTA, no atomics), so a caller can read what the kernel
// computed.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <cstdio>

// Which of the two launches a call makes (bit 0: dQ, bit 1: dK/dV): only
// tools/time_in_turns.py builds with -DPA_BWD_PARTS=1 or 2, to time one
// launch alone.
#ifndef PA_BWD_PARTS
#define PA_BWD_PARTS 3
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;          // rows of every tile (queries or keys)
constexpr int STAGES = 2;       // depth of the ring of streamed tiles
constexpr int THREADS = 256;    // dQ: producer and consumer warpgroups
constexpr int MAX_TILES = 1024; // 64-row tiles of one sequence: s <= 65536
// dQ: 24 + 232 = 2 x 128 registers a thread at launch
constexpr int DQ_REGS = 128, PRODUCER_REGS = 24, CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS + CONSUMER_REGS == 2 * DQ_REGS &&
                  DQ_REGS * THREADS * 2 <= 65536,
              "the dQ register split does not add up to its launch count");
constexpr int BLOCK = BM * 128; // one 64-column block of a tile: 8 KB
constexpr float LOG2E = 1.4426950408889634f;
// returned, and no launch made, when a kernel's register count at launch
// is not the one its setmaxnreg split needs
constexpr int REGISTER_SPLIT = -1;

struct Params {
  // (d, rows, heads, batch) bf16 maps with 64 x 64 boxes, 128-byte swizzle
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const bf16* o;
  const float* lse;   // (b, h, sq), contiguous
  float* delta;       // (b, h, sq), contiguous: written by dq_kernel
  const int* q_seg;
  const int* kv_seg;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int* live_q;   // null, or (b, h, q tiles): live key tiles a dQ CTA found
  int* live_kv;  // null, or (b, kh, key tiles): live q tiles a dK/dV CTA
  int h, kh, sq, sk, d, causal;
  long long o_sb, o_sh, o_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  long long qseg_sb, kvseg_sb;
  float scale;
};

// The dQ kernel's shared memory, in bytes from a 1024-aligned base: the
// resident Q and dO tiles, then a ring of two stages of (K, V).
template <int DP>
struct Layout {
  static constexpr int TILE = DP / 64 * BLOCK;
  static constexpr int RING = 2 * TILE;  // stage s: RING + 2 s TILE
  static constexpr int VEC = RING + STAGES * 2 * TILE;  // 64 key ids a stage
  static constexpr int OWN = VEC + STAGES * BM * 4;  // 64 words: D
  static constexpr int BARS = OWN + BM * 4;  // full[S], empty[S], resident
  static constexpr int LIST = BARS + 64;
  static constexpr int COUNT = LIST + 2 * MAX_TILES;
  static constexpr int BYTES = COUNT + 16 + 1024;  // + slack for the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// one arrival that also announces the bytes the stage's TMA loads bring
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();  // a phase that never completes is a bug: fail, do not hang
    }
  }
}

// 4 bytes global -> shared by cp.async; a src_bytes of 0 reads nothing and
// writes 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
// one arrival on `bar` once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// ------------------------------------------------------------------ TMA
// box (64 columns from c0, 64 rows from c1) of head c2, batch c3
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// a 64-row tile of DP columns: DP / 64 boxes, one per 64-column block
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head,
                                         int batch) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    tma_load(dst + c * BLOCK, map, bar, c * 64, row, head, batch);
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows of 128 bytes, 8-row groups 1024 bytes apart), at
// k-step kk (16 columns) of a tile of DP columns in 64-column blocks
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (the transpose bit): rows 16 t .. 16 t + 15 of a tile as
// the k dimension, its 64-column block c as the n dimension.  Its two
// 8-row groups are 1024 bytes apart; an n of 64 is one swizzle atom wide,
// so no offset between atoms along n is ever taken, and both offsets are
// set to 1024.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int t, int c) {
  return make_desc(tile + c * BLOCK + t * 16 * 128, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses to accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 f32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// K-major; register i of a thread holds row 16 warp + lane / 4 + 8 (i / 2
// % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64 f32) += A (64 x 16 bf16, registers) B (16 x 64), B from shared
// memory through the transpose bit (MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the SFU; -inf (a row with no valid key) gives 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The accumulator of an m64n64 product (rows: this thread's 2 rows;
// columns: the k dimension of the next product) as the bf16 A operand of
// its four k-steps
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&d)[32]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16x2(d[8 * t], d[8 * t + 1]);
    a[t][1] = pack_bf16x2(d[8 * t + 2], d[8 * t + 3]);
    a[t][2] = pack_bf16x2(d[8 * t + 4], d[8 * t + 5]);
    a[t][3] = pack_bf16x2(d[8 * t + 6], d[8 * t + 7]);
  }
}
// Named barriers: 1, the consumer warpgroups; 2, the producer warpgroup's
// scan; 3, the hand-over of the live list (the producer warpgroup arrives,
// the consumers wait).  `n`: the CTA's threads, or its consumers'.
__device__ __forceinline__ void bar_consumers(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}
__device__ __forceinline__ void bar_scan() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later TMA writes there
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void list_published(int n) {
  asm volatile("bar.arrive 3, %0;\n" :: "r"(n) : "memory");
}
__device__ __forceinline__ void list_wait(int n) {
  asm volatile("bar.sync 3, %0;\n" :: "r"(n) : "memory");
}

// ------------------------------------------------------------- liveness
// The id range of rows r0 .. r0 + 63 (< len) of `seg`, over the warp.
__device__ __forceinline__ void tile_range(const int* seg, int r0, int len,
                                           int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  const int a = r0 + lane, b = r0 + 32 + lane;
  const int va = a < len ? seg[a] : 0, vb = b < len ? seg[b] : 0;
  if (a < len) { lo = va; hi = va; }
  if (b < len) { lo = min(lo, vb); hi = max(hi, vb); }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// The CTA's live tiles among the other side's tiles j0 .. j1 - 1 (rows
// 64 j .. of `oth`, length oth_len), against its own rows own0 .. of `own`
// (length own_len), by the forward's skip rule: both tiles hold an id > 0,
// their id ranges (padding included) meet, and under the causal rule some
// key of the pair comes at or before some query.  Run by the producer
// warpgroup (threads 0-127).  32 candidates at a time: their ids are
// requested at once, 16 per thread, into `ids` (2048 words of shared
// memory); then lane j of warp 0 takes candidate j (its 64 ids as 16-byte
// reads in a skewed order, free of bank conflicts), and a ballot with a
// prefix count appends the live ones to `list` in order.  Returns their count, in `*count` too.
__device__ int find_live(const int* own, int own0, int own_len,
                         const int* oth, int oth_len, int j0, int j1,
                         bool own_is_q, int causal, int* ids, uint16_t* list,
                         int* count) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  int lo, hi;
  tile_range(own, own0, own_len, lane, lo, hi);
  const int own_last = min(own0 + BM, own_len) - 1;
  int n = 0;
  for (int c0 = j0; c0 < j1; c0 += 32) {
    const int nt = min(32, j1 - c0);
    const int r0 = c0 * BM, r1 = min((c0 + nt) * BM, oth_len);
    int v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + t + i * 128;
      v[i] = r < r1 ? oth[r] : 0;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) ids[t + i * 128] = v[i];
    bar_scan();
    if (warp == 0) {
      bool live = false;
      if (lane < nt) {
        const int j = c0 + lane, len = min(BM, oth_len - j * BM);
        int olo = INT_MAX, ohi = INT_MIN;
#pragma unroll
        for (int i = 0; i < BM / 4; ++i) {
          const int k = ((i + lane) & (BM / 4 - 1)) * 4;
          const int4 x = reinterpret_cast<const int4*>(ids + lane * BM)[k / 4];
          const int xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < len) {
              olo = min(olo, xs[e]);
              ohi = max(ohi, xs[e]);
            }
        }
        live = hi > 0 && ohi > 0 && ohi >= lo && hi >= olo;
        if (causal)  // the q tile's last row reaches the k tile's first
          live = live && (own_is_q ? j * BM <= own_last
                                   : j * BM + len - 1 >= own0);
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(m & ((1u << lane) - 1))] = c0 + lane;
      n += __popc(m);
    }
    fence_proxy_async();  // TMA reuses `ids`' shared memory afterwards
    bar_scan();  // `ids` is free for the next candidates
  }
  if (t == 0) *count = n;
  return n;
}

// Each consumer warp writes its 16 rows of acc[c] (64-column block c, times
// `mul`) as bf16 into its own rows of the staging area `stg`, then copies
// them to rows row0 + 16 warp .. (< nrows), columns < d, of `g`.
template <int DP>
__device__ __forceinline__ void store_rows(float (&acc)[DP / 64][32],
                                           float mul, bf16* stg, bf16* g,
                                           long long ss, int row0, int nrows,
                                           int d, int warp, int lane) {
  constexpr int LD = DP + 8;  // padded rows: conflict-free bf16x2 writes
  const int gr = lane >> 2, tig = lane & 3;
  bf16* s = stg + warp * 16 * LD;
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + j * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(s + gr * LD + col) =
          __floats2bfloat162_rn(acc[c][4 * j] * mul, acc[c][4 * j + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(s + (gr + 8) * LD + col) =
          __floats2bfloat162_rn(acc[c][4 * j + 2] * mul,
                                acc[c][4 * j + 3] * mul);
    }
  __syncwarp();
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, col = (idx % CH) * 8;
    const int row = row0 + warp * 16 + r;
    if (row < nrows && col < d)
      *reinterpret_cast<uint4*>(g + row * ss + col) =
          *reinterpret_cast<const uint4*>(s + r * LD + col);
  }
  __syncwarp();
}

// D = rowsum(dO * O) of the dQ CTA's 64 rows, from the dO tile (shared
// memory at `sm` + TILE, swizzled) and consumer thread ct's O chunks `ov`
// (half ct % 2 of row ct / 2): into shared memory and `delta` (row 0 of
// the CTA at delta[q0]); returns D of this thread's rows r0 and r1.
template <int DP>
__device__ __forceinline__ void form_d(const uint4 (&ov)[DP / 16],
                                       const uint8_t* sm, float* delta,
                                       int q0, int sq, int ct, int r0, int r1,
                                       float& dl0, float& dl1) {
  using L = Layout<DP>;
  const int rl = ct >> 1, c0 = (ct & 1) * (DP / 2);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 16; ++i) {
    const int col = c0 + i * 8, cc = (col & 63) >> 3;
    const uint4 dv4 = *reinterpret_cast<const uint4*>(
        sm + L::TILE + (col >> 6) * BLOCK + rl * 128 + ((cc ^ (rl & 7)) << 4));
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&dv4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a[e]), y = __bfloat1622float2(b[e]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  float* own = reinterpret_cast<float*>(const_cast<uint8_t*>(sm) + L::OWN);
  if ((ct & 1) == 0) {
    own[rl] = acc;
    if (q0 + rl < sq) delta[q0 + rl] = acc;
  }
  bar_consumers(128);
  dl0 = own[r0];
  dl1 = own[r1];
}

// ------------------------------------------------------------------ (a) dQ
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
    dq_kernel(const __grid_constant__ Params p) {
  using L = Layout<DP>;
  constexpr int NB = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_full = base + L::BARS, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_stay = bar_empty + 8 * STAGES;

  // the dK/dV grid may start once every dQ CTA has: its scan and its K, V
  // and Q, dO loads then fill the SMs the last dQ CTAs leave idle
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int ih = blockIdx.x, ib = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // latest first: most keys
  const int ikh = ih / (p.h / p.kh);
  const int* qsg = p.q_seg + ib * p.qseg_sb;
  const int* ksg = p.kv_seg + ib * p.kvseg_sb;

  if (tid == 0) {  // then Q and dO, while the liveness scan runs
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 33);  // the loads' arrival + 32 lanes
      mbar_init(bar_empty + 8 * s, 128);
    }
    mbar_init(bar_stay, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect(bar_stay, 2 * L::TILE);
    tma_tile<DP>(base, &p.tm_q, bar_stay, q0, ih, ib);
    tma_tile<DP>(base + L::TILE, &p.tm_do, bar_stay, q0, ih, ib);
  }
  __syncthreads();  // the mbarriers are initialised
  uint16_t* list = reinterpret_cast<uint16_t*>(sm + L::LIST);
  int* count = reinterpret_cast<int*>(sm + L::COUNT);

  if (tid < 128) {  // ------------------------------------------- producer
    // the live key tiles, while the consumers compute D; the ring's first
    // stage holds the ids until the first K, V tile is requested
    const int q_last = min(q0 + BM, p.sq) - 1;
    int n_kt = (p.sk + BM - 1) / BM;
    if (p.causal) n_kt = min(n_kt, q_last / BM + 1);
    const int n_live =
        find_live(qsg, q0, p.sq, ksg, p.sk, 0, n_kt, true, p.causal,
                  reinterpret_cast<int*>(sm + L::RING), list, count);
    if (tid == 0 && p.live_q != nullptr)
      p.live_q[(ib * p.h + ih) * gridDim.z + q0 / BM] = n_live;
    list_published(THREADS);
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid >= 32) return;
    const int lane = tid;
    for (int n = 0; n < n_live; ++n) {
      const int s = n % STAGES;
      mbar_wait(bar_empty + 8 * s, ((n / STAGES) & 1) ^ 1);
      const int k0 = list[n] * BM;
      const uint32_t st = base + L::RING + s * 2 * L::TILE;
      if (lane == 0) {
        mbar_arrive_expect(bar_full + 8 * s, 2 * L::TILE);
        tma_tile<DP>(st, &p.tm_k, bar_full + 8 * s, k0, ikh, ib);
        tma_tile<DP>(st + L::TILE, &p.tm_v, bar_full + 8 * s, k0, ikh, ib);
      }
      // the tile's key segment ids by cp.async; past sk: 0 (padding)
      int* kseg = reinterpret_cast<int*>(sm + L::VEC + s * BM * 4);
#pragma unroll
      for (int r = lane; r < BM; r += 32) {
        const bool in = k0 + r < p.sk;
        cp_async4(kseg + r, ksg + (in ? k0 + r : 0), in ? 4 : 0);
      }
      cp_async_arrive(bar_full + 8 * s);
    }
    return;
  }

  // --------------------------------------------------------------- consumer
  const int ct = tid - 128, warp = ct >> 5, lane = ct & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const long long rows0 = (static_cast<long long>(ib) * p.h + ih) * p.sq;
  // this thread's two q rows: segment id and lse in log2 units (D below)
  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  const int qi0 = q0 + r0, qi1 = q0 + r1;
  const int qs0 = qi0 < p.sq ? qsg[qi0] : 0, qs1 = qi1 < p.sq ? qsg[qi1] : 0;
  const float l20 = qi0 < p.sq ? p.lse[rows0 + qi0] * LOG2E : 0.f;
  const float l21 = qi1 < p.sq ? p.lse[rows0 + qi1] * LOG2E : 0.f;
  const float sl2 = p.scale * LOG2E;
  list_wait(THREADS);
  const int n_live = *count;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));

  // D = rowsum(dO * O), formed while the first tile's products run:
  // thread ct takes half (ct % 2) of row ct / 2, its O by 16-byte loads
  float dl0 = 0.f, dl1 = 0.f;
  uint4 ov[DP / 16];
  {
    const int row = q0 + (ct >> 1), c0 = (ct & 1) * (DP / 2);
    const bf16* og = p.o + ib * p.o_sb + ih * p.o_sh + row * p.o_ss;
#pragma unroll
    for (int i = 0; i < DP / 16; ++i) {
      const int col = c0 + i * 8;
      ov[i] = row < p.sq && col < p.d
                  ? *reinterpret_cast<const uint4*>(og + col)
                  : make_uint4(0, 0, 0, 0);
    }
  }
  mbar_wait(bar_stay, 0);  // Q and dO

  float dq[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  for (int n = 0; n < n_live; ++n) {
    const int s = n % STAGES;
    mbar_wait(bar_full + 8 * s, (n / STAGES) & 1);
    const uint32_t ks = base + L::RING + s * 2 * L::TILE, vs = ks + L::TILE;
    const int* kseg = reinterpret_cast<const int*>(sm + L::VEC + s * BM * 4);
    const int k0 = list[n] * BM;

    // S = Q K^T, dP = dO V^T
    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(sc, desc_k(base, kk), desc_k(ks, kk), kk);
      wgmma_ss(dp, desc_k(base + L::TILE, kk), desc_k(vs, kk), kk);
    }
    wg_commit();
    if (n == 0)
      form_d<DP>(ov, sm, p.delta + rows0, q0, p.sq, ct, r0, r1, dl0, dl1);
    wg_wait0();
    reg_fence(sc);
    reg_fence(dp);

    // P = exp(S scale - lse) on the mask, dS = P (dP - D), in dp
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + tig * 2 + e, kj = k0 + c, sg = kseg[c];
        const bool v0 = sg == qs0 && sg > 0 && (!p.causal || qi0 >= kj);
        const bool v1 = sg == qs1 && sg > 0 && (!p.causal || qi1 >= kj);
        const float p0 = v0 ? fast_exp2(fmaf(sc[4 * j + e], sl2, -l20)) : 0.f;
        const float p1 =
            v1 ? fast_exp2(fmaf(sc[4 * j + 2 + e], sl2, -l21)) : 0.f;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
      }
    uint32_t da[4][4];
    to_a(da, dp);

    // dQ += dS K
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < NB; ++c) wgmma_rs_tb(dq[c], da[t], desc_mn(ks, t, c));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NB; ++c) reg_fence(dq[c]);
    mbar_arrive(bar_empty + 8 * s);
  }

  if (n_live == 0)
    form_d<DP>(ov, sm, p.delta + rows0, q0, p.sq, ct, r0, r1, dl0, dl1);

  // ---- dQ (scaled), staged in the Q and dO tiles ---------------------------
  bar_consumers(128);  // every warp is past its last product
  store_rows<DP>(dq, p.scale, reinterpret_cast<bf16*>(sm),
                 p.dq + ib * p.dq_sb + ih * p.dq_sh, p.dq_ss, q0, p.sq, p.d,
                 warp, lane);
}

// ------------------------------------------------------------ (b) dK, dV
// Two consumer warpgroups take the CTA's items in turn (even, odd), each
// with its own ring of two stages, and sum dK and dV separately; at the end
// each writes one of its partial sums to shared memory and adds the other's
// (a fixed order: the gradients stay bitwise deterministic).
constexpr int KV_THREADS = 384;  // producer + two consumer warpgroups
// 40 + 2 x 232 = 3 x 168 registers a thread at launch
constexpr int KV_REGS = 168, KV_PRODUCER_REGS = 40, KV_CONSUMER_REGS = 232;
static_assert(KV_PRODUCER_REGS + 2 * KV_CONSUMER_REGS == 3 * KV_REGS &&
                  KV_REGS * KV_THREADS <= 65536,
              "the dK/dV register split does not add up to its launch count");

template <int DP>
struct KvLayout {
  static constexpr int TILE = DP / 64 * BLOCK;
  static constexpr int RING = 2 * TILE;  // slot (consumer c, stage s):
  static constexpr int SLOTS = 2 * STAGES;  // RING + 2 (c STAGES + s) TILE
  static constexpr int VEC = RING + SLOTS * 2 * TILE;  // 3 x 64 words a slot
  static constexpr int BARS = VEC + SLOTS * 3 * BM * 4;  // full, empty, K/V
  static constexpr int LIST = BARS + 8 * (2 * SLOTS + 1);
  static constexpr int COUNT = LIST + 2 * MAX_TILES;
  static constexpr int BYTES = COUNT + 16 + 1024;
  // after the products: each consumer's bf16 staging, then the partials
  static constexpr int STAGING = BM * (DP + 8) * 2;
  static constexpr int PART = (2 * STAGING + 1023) / 1024 * 1024;
  static_assert(PART + 2 * BM * DP * 4 <= VEC, "partials overrun the ring");
};

// A consumer's accumulator (thread ct's registers) to and from shared
// memory, 16 bytes a store, consecutive threads on consecutive addresses.
template <int DP>
__device__ __forceinline__ void put_part(const float (&a)[DP / 64][32],
                                         float4* dst, int ct) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[(c * 8 + i) * 128 + ct] = make_float4(
          a[c][4 * i], a[c][4 * i + 1], a[c][4 * i + 2], a[c][4 * i + 3]);
}
template <int DP>
__device__ __forceinline__ void add_part(float (&a)[DP / 64][32],
                                         const float4* src, int ct) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 o = src[(c * 8 + i) * 128 + ct];
      a[c][4 * i] += o.x;
      a[c][4 * i + 1] += o.y;
      a[c][4 * i + 2] += o.z;
      a[c][4 * i + 3] += o.w;
    }
}

template <int DP>
__global__ void __launch_bounds__(KV_THREADS, 1)
    dkdv_kernel(const __grid_constant__ Params p) {
  using L = KvLayout<DP>;
  constexpr int NB = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_full = base + L::BARS;
  const uint32_t bar_empty = bar_full + 8 * L::SLOTS;
  const uint32_t bar_stay = bar_empty + 8 * L::SLOTS;

  const int tid = threadIdx.x;
  const int ikh = blockIdx.x, ib = blockIdx.y;
  const int k0 = blockIdx.z * BM;
  const int group = p.h / p.kh;
  const int* qsg = p.q_seg + ib * p.qseg_sb;
  const int* ksg = p.kv_seg + ib * p.kvseg_sb;

  if (tid == 0) {  // then K and V, while the liveness scan runs
    for (int s = 0; s < L::SLOTS; ++s) {
      mbar_init(bar_full + 8 * s, 33);
      mbar_init(bar_empty + 8 * s, 128);
    }
    mbar_init(bar_stay, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect(bar_stay, 2 * L::TILE);
    tma_tile<DP>(base, &p.tm_k, bar_stay, k0, ikh, ib);
    tma_tile<DP>(base + L::TILE, &p.tm_v, bar_stay, k0, ikh, ib);
  }
  __syncthreads();  // the mbarriers are initialised
  uint16_t* list = reinterpret_cast<uint16_t*>(sm + L::LIST);
  int* count = reinterpret_cast<int*>(sm + L::COUNT);

  if (tid < 128) {  // ------------------------------------------- producer
    // the live q tiles; under the causal rule none before the one holding
    // query k0
    const int n_qt = (p.sq + BM - 1) / BM;
    const int qt0 = p.causal ? min(k0 / BM, n_qt) : 0;
    const int n_live =
        find_live(ksg, k0, p.sk, qsg, p.sq, qt0, n_qt, false, p.causal,
                  reinterpret_cast<int*>(sm + L::RING), list, count);
    if (tid == 0 && p.live_kv != nullptr)
      p.live_kv[(ib * p.kh + ikh) * gridDim.z + blockIdx.z] = n_live;
    list_published(KV_THREADS);
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(KV_PRODUCER_REGS));
    if (tid >= 32) return;
    const int lane = tid;
    const int n_items = group * n_live;  // (q head of the group, q tile)
    // D comes from the dQ grid: wait until it has finished and its writes
    // are visible (the items' Q and dO are inputs, but their D is not)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    int g = 0, li = 0;
    for (int n = 0; n < n_items; ++n) {
      const int m = n >> 1, slot = (n & 1) * STAGES + (m & 1);
      mbar_wait(bar_empty + 8 * slot, ((m >> 1) & 1) ^ 1);
      const int ih = ikh * group + g, q0 = list[li] * BM;
      const uint32_t st = base + L::RING + slot * 2 * L::TILE;
      const uint32_t full = bar_full + 8 * slot;
      if (lane == 0) {
        mbar_arrive_expect(full, 2 * L::TILE);
        tma_tile<DP>(st, &p.tm_q, full, q0, ih, ib);
        tma_tile<DP>(st + L::TILE, &p.tm_do, full, q0, ih, ib);
      }
      // lse, D and the segment id of the item's 64 q rows by cp.async,
      // arriving on the stage's mbarrier when they land; rows past sq read
      // as 0 (padding)
      float* vec = reinterpret_cast<float*>(sm + L::VEC + slot * 3 * BM * 4);
      const long long rows0 = (static_cast<long long>(ib) * p.h + ih) * p.sq;
#pragma unroll
      for (int r = lane; r < BM; r += 32) {
        const int qi = q0 + r, nb = qi < p.sq ? 4 : 0;
        const long long at = qi < p.sq ? rows0 + qi : 0;
        cp_async4(vec + r, p.lse + at, nb);
        cp_async4(vec + BM + r, p.delta + at, nb);
        cp_async4(vec + 2 * BM + r, qsg + (qi < p.sq ? qi : 0), nb);
      }
      cp_async_arrive(full);
      if (++li == n_live) {
        li = 0;
        ++g;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int cw = (tid >> 7) - 1;  // consumer warpgroup 0 or 1
  const int ct = tid & 127, warp = ct >> 5, lane = ct & 31;
  const int gr = lane >> 2, tig = lane & 3;
  // this thread's two keys
  const int kj0 = k0 + warp * 16 + gr, kj1 = kj0 + 8;
  const int ks0 = kj0 < p.sk ? ksg[kj0] : 0, ks1 = kj1 < p.sk ? ksg[kj1] : 0;
  const float sl2 = p.scale * LOG2E;
  list_wait(KV_THREADS);
  const int n_live = *count, n_items = group * n_live;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(KV_CONSUMER_REGS));

  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  mbar_wait(bar_stay, 0);

  for (int n = cw, m = 0; n < n_items; n += 2, ++m) {
    const int slot = cw * STAGES + (m & 1);
    mbar_wait(bar_full + 8 * slot, (m >> 1) & 1);
    const uint32_t qs = base + L::RING + slot * 2 * L::TILE, dos = qs + L::TILE;
    const float* vec =
        reinterpret_cast<const float*>(sm + L::VEC + slot * 3 * BM * 4);
    const int q0 = list[n % n_live] * BM;

    // S^T = K Q^T, dP^T = V dO^T (rows: keys; columns: queries)
    float st[32], dpt[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(st, desc_k(base, kk), desc_k(qs, kk), kk);
      wgmma_ss(dpt, desc_k(base + L::TILE, kk), desc_k(dos, kk), kk);
    }
    wg_commit();
    wg_wait0();
    reg_fence(st);
    reg_fence(dpt);

    // P^T = exp(S^T scale - lse) on the mask, in st
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + tig * 2 + e, qi = q0 + c;
        const float l2 = vec[c] * LOG2E;
        const int sg = reinterpret_cast<const int*>(vec)[2 * BM + c];
        const bool v0 = sg == ks0 && ks0 > 0 && (!p.causal || qi >= kj0);
        const bool v1 = sg == ks1 && ks1 > 0 && (!p.causal || qi >= kj1);
        st[4 * j + e] = v0 ? fast_exp2(fmaf(st[4 * j + e], sl2, -l2)) : 0.f;
        st[4 * j + 2 + e] =
            v1 ? fast_exp2(fmaf(st[4 * j + 2 + e], sl2, -l2)) : 0.f;
      }
    uint32_t pa[4][4], da[4][4];
    to_a(pa, st);
    // dV += P^T dO, running while dS^T = P^T (dP^T - D) is formed
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < NB; ++c)
        wgmma_rs_tb(dv[c], pa[t], desc_mn(dos, t, c));
    wg_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = vec[BM + j * 8 + tig * 2 + e];
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl);
        dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dl);
      }
    to_a(da, dpt);
    // dK += dS^T Q
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < NB; ++c)
        wgmma_rs_tb(dk[c], da[t], desc_mn(qs, t, c));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      reg_fence(dv[c]);
      reg_fence(dk[c]);
    }
    mbar_arrive(bar_empty + 8 * slot);
  }

  // ---- the two partial sums: consumer 0 writes dK (scaled), consumer 1 dV
  bar_consumers(256);  // every product is done: the ring is free
  float4* mine = reinterpret_cast<float4*>(sm + L::PART) + cw * BM * DP / 4;
  const float4* theirs = reinterpret_cast<const float4*>(sm + L::PART) +
                         (1 - cw) * BM * DP / 4;
  if (cw == 0)
    put_part<DP>(dv, mine, ct);
  else
    put_part<DP>(dk, mine, ct);
  bar_consumers(256);
  bf16* stg = reinterpret_cast<bf16*>(sm + cw * L::STAGING);
  if (cw == 0) {
    add_part<DP>(dk, theirs, ct);
    store_rows<DP>(dk, p.scale, stg, p.dk + ib * p.dk_sb + ikh * p.dk_sh,
                   p.dk_ss, k0, p.sk, p.d, warp, lane);
  } else {
    add_part<DP>(dv, theirs, ct);
    store_rows<DP>(dv, 1.f, stg, p.dv + ib * p.dv_sb + ikh * p.dv_sh,
                   p.dv_ss, k0, p.sk, p.d, warp, lane);
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (batch, heads, rows, d) bf16 tensor at `ptr`, with strides in
// elements, as a map of 64-row x 64-column boxes in the 128-byte-swizzled
// layout; rows past `rows` and columns past d read as zeros.  A dimension
// of extent 1 is never stepped, so its stride is replaced by the packed one.
bool make_map(CUtensorMap* map, const void* ptr, int b, int heads, int rows,
              int d, long long sb, long long sh, long long ss) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t packed[3] = {
      static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(d) * 2 * rows,
      static_cast<cuuint64_t>(d) * 2 * rows * heads};
  const long long given[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? packed[i]
                                  : static_cast<cuuint64_t>(given[i]) * 2;
  const cuuint32_t box[4] = {64, BM, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The registers each kernel gets at launch, as this build's ptxas chose
// them, against the counts the setmaxnreg split is written for.
template <int DP>
int check_registers() {
  cudaFuncAttributes q, kv;
  cudaError_t err = cudaFuncGetAttributes(&q, dq_kernel<DP>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&kv, dkdv_kernel<DP>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q.numRegs == DQ_REGS && kv.numRegs == KV_REGS) return 0;
  std::fprintf(stderr,
               "packed_attention_bwd: ptxas gave dq_kernel<%d> %d and "
               "dkdv_kernel<%d> %d registers; the setmaxnreg split needs %d "
               "and %d\n", DP, q.numRegs, DP, kv.numRegs, DQ_REGS, KV_REGS);
  return REGISTER_SPLIT;
}

template <int DP>
int launch_dp(const Params& p, int b, cudaStream_t stream) {
  static const int regs = check_registers<DP>();  // the binary's: once
  if (regs != 0) return regs;
  constexpr int smem_q = Layout<DP>::BYTES, smem_kv = KvLayout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  if (PA_BWD_PARTS & 1) {  // dQ, and D for the dK/dV kernel
    const dim3 grid(p.h, b, (p.sq + BM - 1) / BM);
    dq_kernel<DP><<<grid, THREADS, smem_q, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (PA_BWD_PARTS & 2) {  // may start before the dQ grid ends (above)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.kh, b, (p.sk + BM - 1) / BM);
    cfg.blockDim = dim3(KV_THREADS);
    cfg.dynamicSmemBytes = smem_kv;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dkdv_kernel<DP>, p);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// ptrs: q, k, v, o, dout, lse, delta, q_seg, kv_seg, dq, dk, dv, live.
// strides: the (batch, head, row) strides in elements of q, k, v, o, dout,
// dq, dk and dv (24), then the batch strides of q_seg and kv_seg.  q, o,
// dout, dq: (b, h, sq, d); k, v, dk, dv: (b, kh, sk, d); all bfloat16 with a
// unit last stride, 16-byte aligned pointers and strides; lse and delta
// contiguous (b, h, sq) float32; segment ids int32 (b, s) with a unit last
// stride; live null, or int32 with b h ceil(sq / 64) + b kh ceil(sk / 64)
// entries (each CTA's live tile count: dQ CTAs, then dK/dV CTAs).
// d % 16 == 0, d <= 128, sq and sk <= 65536.  Two launches on `stream`;
// returns the first cudaError_t that is not 0, REGISTER_SPLIT (-1, no
// launch) when this build's register counts do not fit the kernels'
// setmaxnreg split, or 0.
extern "C" int packed_attention_bwd_launch(
    void* const* ptrs, const long long* strides, int b, int h, int kh,
    int sq, int sk, int d, float scale, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0 || d <= 0 ||
      d > 128 || d % 16 != 0 || sq > BM * MAX_TILES || sk > BM * MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const long long* st = strides;
  if (!make_map(&p.tm_q, ptrs[0], b, h, sq, d, st[0], st[1], st[2]) ||
      !make_map(&p.tm_k, ptrs[1], b, kh, sk, d, st[3], st[4], st[5]) ||
      !make_map(&p.tm_v, ptrs[2], b, kh, sk, d, st[6], st[7], st[8]) ||
      !make_map(&p.tm_do, ptrs[4], b, h, sq, d, st[12], st[13], st[14]))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<const bf16*>(ptrs[3]);
  p.lse = static_cast<const float*>(ptrs[5]);
  p.delta = static_cast<float*>(ptrs[6]);
  p.q_seg = static_cast<const int*>(ptrs[7]);
  p.kv_seg = static_cast<const int*>(ptrs[8]);
  p.dq = static_cast<bf16*>(ptrs[9]);
  p.dk = static_cast<bf16*>(ptrs[10]);
  p.dv = static_cast<bf16*>(ptrs[11]);
  p.live_q = static_cast<int*>(ptrs[12]);
  const long long n_dq_ctas =
      static_cast<long long>(b) * h * ((sq + BM - 1) / BM);
  p.live_kv = p.live_q == nullptr ? nullptr : p.live_q + n_dq_ctas;
  p.h = h;
  p.kh = kh;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_ss = st[11];
  long long* dst[] = {&p.dq_sb, &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh,
                      &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss, &p.qseg_sb,
                      &p.kvseg_sb};
  for (int i = 0; i < 11; ++i) *dst[i] = st[15 + i];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch_dp<64>(p, b, s) : launch_dp<128>(p, b, s);
}
