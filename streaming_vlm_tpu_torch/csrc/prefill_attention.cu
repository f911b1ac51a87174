// Chunk-prefill attention over the streaming KV arena plus the chunk's own
// block (kernel K1 of the port), written for the H100.
//
// Replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_prefill_attention` / `_flash_kernel` (its pallas_call at :854):
// GQA flash attention of a T-token chunk over two KV sources under ONE
// online softmax in log2/exp2 form. Arena slots < visible_len are visible
// with no causal mask; the chunk's own block is causal. The arena K is
// either pre-rotated (the engine's mode) or raw, with per-slot
// duplicated-half cos/sin (raw mode).
//
// What bounds it on an H100: at the 7B path's T=640 (G=7, Hkv=4, hd=128)
// and 9600 visible slots it does 4 * T * H * hd * (visible + (T+1)/2) =
// 91.0 GFLOP on ~20 MB of inputs: 0.0920 ms at the bf16 tensor-core peak
// against 0.006 ms of bytes, so it is bound by operations. What the design
// does about it:
//   * both products are wgmma (m64n128k16, bf16 in, f32 accumulate). Each
//     of two consumer warpgroups owns 64 packed query rows; S = Q K^T reads
//     Q and K from shared memory (both hd-contiguous: K-major); the f32 S
//     fragment is rescaled, exponentiated and packed to bf16 in registers,
//     where it is exactly the A fragment of O += P V, whose V is read from
//     shared memory MN-major (the descriptor's transpose bit). S, P, the
//     running (m, l) and O never leave registers inside the key loop;
//   * the key loop keeps the tensor cores fed through the softmax (the
//     schedule of FlashAttention-3, Shah et al. 2024, sections 3.1-3.2).
//     Run serially, a warpgroup's tile is S = Q K^T, a wait, the softmax
//     (16384 exp2f a tile on the SFU, ~1024 clocks against the products'
//     ~2048), P . V, a wait: the tensor cores idle through every softmax,
//     and the two warpgroups, waiting on the same stage, softmax at the
//     same time. Instead, within a warpgroup, S of tile j + 1 is issued
//     (and committed) together with P . V of tile j, and wgmma_wait<1>
//     returns with S done and P . V still in flight: the softmax of tile
//     j + 1 runs under it, O's rescale and P's packing after it. Between
//     the warpgroups, named barriers (BAR_TURN + wg) hand a turn back and
//     forth: a warpgroup issues its two products only in its turn, then
//     passes the turn on and runs its softmax while the other's products
//     run (ping-pong). The operations and their order per tile are the
//     serial loop's, so the output and log-sum-exp are bitwise what it
//     gave (tools/ab_torch.py hashes both), but where a P or an alpha falls
//     under 2^-126: they come from the SFU's ex2.approx.ftz, which flushes
//     those to 0 where exp2f keeps them subnormal; exp2f's range check and
//     two scalings a call cost 3-4% of the loop at every shape measured.
//     O's rescale is skipped where every alpha of a warp's rows is exactly
//     1 (exact). Registers: O (64), S (64) and P (32) a thread; setmaxnreg
//     gives the consumers 240, the producer 24; ptxas spills nothing;
//   * K/V tiles of BN = 128 keys arrive by TMA into a ring of STAGES = 3
//     stages (the 128-byte swizzle the wgmma descriptors read; 3 x 64 KB
//     + the Q tiles' 32 KB: 225 KB of shared memory), issued by one
//     producer thread ahead of the consumers and tracked by mbarriers
//     (full: bytes landed; empty: both warpgroups are done with a stage's
//     K, once S over it is done, or with its V, once P . V is: K is handed
//     back half a tile earlier). A consumer holds two stages at once (S of
//     tile j + 1, P . V of tile j), so two stages left the producer no
//     tile to load ahead: 3 stages were 1.24x as fast as 2 in the
//     full-block mode at T = 4096 and at T = 640 over 9600 slots
//     (tools/ab_torch.py, medians of 6, NVIDIA H100 80GB HBM3 at 700 W);
//     TMA rather than cp.async: the producer spends no registers or
//     instructions on addresses, the consumers none on copies, and keys at
//     or past the limit (visible_len for the arena, T for the self block)
//     lie outside the tensor map and arrive as zeros, so P . V never meets
//     a stale or non-finite arena row. The maps are encoded per call on the
//     host (the arena pointer changes with every layer);
//   * masks only where needed: interior arena tiles and self tiles wholly
//     below the warpgroup's first token are unmasked; only the tile that
//     holds visible_len and the self tiles on the causal diagonal are;
//   * packed GQA rows: row r of a kv head is (token r / G, head r % G), so
//     G = 7 is only a row count; the ragged last tile computes zero rows
//     that are never stored;
//   * a grid sized to the card: the work of a call is the list of (kv
//     head, 128-row tile, key tile) units, in that order, cut into one
//     contiguous, equal share for each of n_ctas <= #SMs persistent CTAs
//     (one per SM: 225 KB of shared memory, 384 threads). A share that
//     covers a row tile's keys only in part stores its unnormalised
//     log2-space partials (m, l, O) and a second small pass merges them.
//     So T = 640 (4 x 35 row tiles x ~77 key tiles) and T = 64 (16 row
//     tiles) both fill all 132 SMs in one wave. The plan (which CTA runs
//     which units) is made on the host: ops/attention.py `prefill_plan`;
//   * raw mode rotates each visible arena key once per call (a pass into
//     a bf16 scratch, f32 arithmetic with no contraction, then rounded, as
//     the plain version does), not once per row tile; the attention then
//     reads the scratch as a pre-rotated arena;
//   * lanes: one call serves B independent streams (the multi-stream
//     engine's round), each with its own queries, arena (lane-strided: a
//     layer of a [B, L, C, Hkv, HD] arena), self block and visible length.
//     The plan's units are (lane, kv head, row tile, key tile), so one
//     grid of persistent CTAs spreads all lanes' work over the SMs; a
//     segment's "head" is lane * Hkv + kv head, and the lanes' visible
//     lengths travel with the plan. The tensor maps get a lane axis; the
//     arena's row bound is the lanes' largest visible length, so a lane's
//     tile that holds its own visible_len may read its later (finite,
//     masked) slots.
//   * training: the forward of causal self-attention is this kernel at
//     visible 0 (ops/attention.py `train_attention`), and its backward
//     (csrc/attention_bwd.cu, K1-bwd) needs each query row's log-sum-exp.
//     Given an `lse` pointer, the kernel writes it for every (lane, token,
//     head) as f32 in K1's log2 space: lse2 = m + log2(l) over the row's
//     scaled logits (q * softmax-scale * log2(e), q rounded to bf16), so
//     that P = exp2(s2 - lse2); the natural log-sum-exp is lse2 * ln(2).
//     A row the plan splits gets it from the merge pass. The kernel is a
//     template on whether it writes the LSE, so serving (a null pointer)
//     runs the instantiation without it, the code it ran before the LSE
//     existed: a runtime branch in the epilogue alone cost ~3.5% at T = 640
//     (tools/ab_torch.py on an H100).
//   * a segment's Q: each thread's 8 16-byte loads are issued together,
//     the next segment's once this one's last P . V is done. Issued one
//     after another, each waited a memory latency: 15% of the time at T =
//     10240 visible 0, 24% of the MCQ batch's (tools/ab_torch.py). Issued
//     before a wgmma fence, they held the warpgroup's next products;
//   * full-block mode (ring attention, parallel/ring.py): T queries over a
//     key block that lies wholly before them, its keys pre-rotated, no
//     causal self block, the log-sum-exp written. It replaces the XLA
//     einsums and online softmax of a ring step over an earlier block
//     (streaming_vlm_tpu/parallel/ring.py:45). It is a plan with no
//     self (diagonal) units (ops/attention.py `prefill_plan(...,
//     self_block=False)`): the kernel walks the block as fully visible
//     arena tiles, and the entry point, given no self block, points the
//     self maps at the arena's (never read). Bound: 4 H hd T S operations,
//     240.5 GFLOP at T = S = 4096 (7B heads), 0.2432 ms at the bf16 peak.
//     Device time there (tools/ab_torch.py in turns, medians of 6, NVIDIA
//     H100 80GB HBM3, 700.00 W): 0.4017 ms, 60.5% of the bound, against
//     0.4911 ms for the serial loop it replaced; SDPA's non-causal forward
//     (cuDNN) took 0.3703 ms in chip_smoke.py's run on that card.
//
// Built by nvcc for sm_90a into a plain-C shared library (see
// streaming_vlm_tpu_torch/ops/_kernels.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HD = 128;        // head dim (the wrapper rejects others)
constexpr int BM = 128;        // packed query rows per work tile
constexpr int BN = 128;        // keys per K/V tile
constexpr int CONSUMERS = 2;   // warpgroups of 64 rows each
constexpr int STAGES = 3;      // K/V ring depth
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + one producer warpgroup
constexpr int WG_ROWS = BM / CONSUMERS;
constexpr int Q_BYTES = WG_ROWS * HD * 2;   // one warpgroup's Q tile: 16 KB
constexpr int KV_BYTES = BN * HD * 2;       // one K or V tile: 32 KB
constexpr int BOX_BYTES = KV_BYTES / 2;     // one TMA box: 64 of the 128 columns
constexpr int SEG_INTS = 5;                 // kv head, row tile, unit begin, unit end, partial
constexpr int MERGE_INTS = 4;               // kv head, row tile, first partial, count
constexpr int MERGE_ROWS = 16;              // rows per CTA of the merge pass
// named barriers: 1 + wg, a consumer warpgroup's own (its Q tile); BAR_TURN
// + wg, warpgroup wg's turn to issue its products (ping-pong)
constexpr int BAR_TURN = 3;
constexpr size_t SMEM_BYTES =
    1024 + CONSUMERS * Q_BYTES + 2 * STAGES * KV_BYTES + 4 * STAGES * sizeof(uint64_t);

static_assert(HD == 128 && BN == 128 && WG_ROWS == 64, "wgmma shapes below assume these");
static_assert(WG_ROWS * (HD / 8) % 128 == 0, "a warpgroup's Q tile in whole 16-byte loads a thread");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x by the SFU's instruction alone: the same bits as exp2f wherever the
// result is at least 2^-126 (exp2f is this instruction plus a range check
// and two scalings that keep smaller results subnormal); here they flush to
// 0, a P or an alpha under 2^-126 of the row's largest term, which is 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the self block's causal limit: key j is visible to token t
__device__ __forceinline__ bool causal_ok(int key, int t) { return key <= t; }

template <bool LSE>
__global__ void __launch_bounds__(THREADS, 1) prefill_attention_kernel(
    const __grid_constant__ CUtensorMap ka_map,  // arena K (pre-rotated) [B][rows, Hkv, HD]
    const __grid_constant__ CUtensorMap va_map,
    const __grid_constant__ CUtensorMap ks_map,  // self block [B][T, Hkv, HD]
    const __grid_constant__ CUtensorMap vs_map,
    const bf16* __restrict__ q,    // [B, T, H, HD]
    bf16* __restrict__ out,        // [B, T, H, HD]
    float* __restrict__ part_o,    // [n_partials, BM, HD]
    float* __restrict__ part_ml,   // [n_partials, 2, BM]
    const int* __restrict__ segs,  // [n_segs, SEG_INTS]
    const int* __restrict__ cta_segs,  // [n_ctas + 1]
    const int* __restrict__ vis,   // [B] each lane's visible arena slots
    float* __restrict__ lse,       // [B, T, H] log2-space log-sum-exp, or null
    int T, int H, int Hkv, int G, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sK = smem + CONSUMERS * Q_BYTES;
  unsigned char* sV = sK + STAGES * KV_BYTES;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sV + STAGES * KV_BYTES);
  uint64_t* vfull = kfull + STAGES;
  uint64_t* kempty = vfull + STAGES;
  uint64_t* vempty = kempty + STAGES;

  const int wg = threadIdx.x / 128;
  const int seg_begin = cta_segs[blockIdx.x];
  const int seg_end = cta_segs[blockIdx.x + 1];

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], CONSUMERS * 4);  // lane 0 of every consumer warp
      mbar_init(&vempty[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the K/V ring full
    regs_dealloc<24>();
    if (threadIdx.x % 128 == 0) {
      tma_prefetch_map(&ka_map);
      tma_prefetch_map(&va_map);
      tma_prefetch_map(&ks_map);
      tma_prefetch_map(&vs_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int si = seg_begin; si < seg_end; ++si) {
        const int* sg = segs + si * SEG_INTS;
        const int b = sg[0] / Hkv, kvh = sg[0] % Hkv;  // lane, kv head
        const int n_arena = (vis[b] + BN - 1) / BN;
        for (int u = sg[2]; u < sg[3]; ++u) {
          const bool arena = u < n_arena;
          const CUtensorMap* km = arena ? &ka_map : &ks_map;
          const CUtensorMap* vm = arena ? &va_map : &vs_map;
          const int key0 = (arena ? u : u - n_arena) * BN;
          unsigned char* k_dst = sK + stage * KV_BYTES;
          unsigned char* v_dst = sV + stage * KV_BYTES;
          mbar_wait(&kempty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&kfull[stage], KV_BYTES);
          tma_load_4d(k_dst, km, &kfull[stage], 0, kvh, key0, b);
          tma_load_4d(k_dst + BOX_BYTES, km, &kfull[stage], 64, kvh, key0, b);
          mbar_wait(&vempty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&vfull[stage], KV_BYTES);
          tma_load_4d(v_dst, vm, &vfull[stage], 0, kvh, key0, b);
          tma_load_4d(v_dst + BOX_BYTES, vm, &vfull[stage], 64, kvh, key0, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // stay until the consumers have released every stage in flight
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(&kempty[stage], phase ^ 1);
        mbar_wait(&vempty[stage], phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [wg * 64, wg * 64 + 64) of a tile
    regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int R = T * G;
    unsigned char* q_tile = sQ + wg * Q_BYTES;
    int stage = 0;
    uint32_t phase = 0;
    if (wg == 1) named_barrier_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn

    // Q of a segment: this thread's 8 16-byte chunks of the warpgroup's
    // rows, loaded together into registers; the next segment's are issued
    // once this one's last P . V is done (a load in flight when a wgmma
    // fence is reached holds the warpgroup's next products), so that their
    // latency hides behind the epilogue
    constexpr int Q_LOADS = WG_ROWS * (HD / 8) / 128;
    uint4 qx[Q_LOADS];
    auto load_q = [&](int sj) {
      const int* sg = segs + sj * SEG_INTS;
      const int b = sg[0] / Hkv, kvh = sg[0] % Hkv;  // lane, kv head
      const int r0 = sg[1] * BM + wg * WG_ROWS;
      const bf16* qb = q + (size_t)b * T * H * HD;
#pragma unroll
      for (int j = 0; j < Q_LOADS; ++j) {
        const int i = tid + 128 * j;
        const int gr = r0 + i / (HD / 8);
        qx[j] = make_uint4(0u, 0u, 0u, 0u);
        if (gr < R) {
          const int t = gr / G;
          const int g = gr - t * G;
          qx[j] = *reinterpret_cast<const uint4*>(
              qb + ((size_t)t * H + kvh * G + g) * HD + (i % (HD / 8)) * 8);
        }
      }
    };
    load_q(seg_begin);

    for (int si = seg_begin; si < seg_end; ++si) {
      const int* sg = segs + si * SEG_INTS;
      const int b = sg[0] / Hkv, kvh = sg[0] % Hkv;  // lane, kv head
      const int rt = sg[1], u_begin = sg[2], u_end = sg[3], part = sg[4];
      const int r0 = rt * BM + wg * WG_ROWS;  // this warpgroup's first packed row
      const int n_arena = (vis[b] + BN - 1) / BN;

      // Q (in qx): scaled by softmax-scale * log2(e) in f32, rounded to
      // bf16, stored in the 128-byte swizzle (two 64-column halves of 8 KB)
      named_barrier_sync(1 + wg, 128);  // the last segment's reads of q_tile are done
#pragma unroll
      for (int j = 0; j < Q_LOADS; ++j) {
        const int i = tid + 128 * j;
        const int row = i / (HD / 8);
        const int c16 = i % (HD / 8);  // 16-byte chunk of the row
        uint4 v;
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&qx[j]);
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          w[e] = pack_bf16(f.x * qscale, f.y * qscale);
        }
        const int half = c16 / 8;
        const int chunk = (c16 % 8) ^ (row % 8);
        *reinterpret_cast<uint4*>(q_tile + half * (Q_BYTES / 2) + row * 128 + chunk * 16) = v;
      }
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);

      // rows of this thread in the accumulator layout, and their tokens
      const int ra = r0 + warp * 16 + lane / 4;
      const int rb = ra + 8;
      const int ta = ra / G, tb = rb / G;
      const int t_first = r0 / G;  // the warpgroup's first token
      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float alpha_a, alpha_b;
      float s[64];             // S of the tile in the softmax, then of the next one
      uint32_t p[BN / 16][4];  // P of the tile whose P . V is pending, bf16

      // mask S of unit u where needed, then one online-softmax step in log2
      // space: m and l updated, alpha (O's rescale) out
      auto softmax = [&](int u) {
        // mask the tile that holds visible_len (the last arena tile) and the
        // self tiles on the diagonal; every other tile is wholly visible
        const bool arena = u < n_arena;
        const int key0 = (arena ? u : u - n_arena) * BN;
        const bool masked = arena ? u + 1 == n_arena : key0 + BN - 1 > t_first;
        if (masked) {
          // the lane's visible length, read back from the plan (kept out of
          // the loop's registers)
          const int visible_len = arena ? vis[segs[si * SEG_INTS] / Hkv] : 0;
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
            const int t = (i & 2) ? tb : ta;
            const bool ok = arena ? key < visible_len : causal_ok(key, t);
            s[i] = ok ? s[i] : -INFINITY;
          }
        }
        // rows a (i & 2 == 0) and b
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int i = 0; i < 64; i += 4) {
          mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // a row with no visible key so far keeps m = -inf: subtract 0
        const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
        const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
        alpha_a = ex2(m_a - base_a);
        alpha_b = ex2(m_b - base_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < 64; i += 4) {
          s[i] = ex2(s[i] - base_a);
          s[i + 1] = ex2(s[i + 1] - base_a);
          s[i + 2] = ex2(s[i + 2] - base_b);
          s[i + 3] = ex2(s[i + 3] - base_b);
          sum_a += s[i] + s[i + 1];
          sum_b += s[i + 2] + s[i + 3];
        }
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
      };
      // O *= alpha, skipped where every alpha of the warp's rows is exactly 1
      // (the running maxima unchanged: exact), then P in bf16 from S. The S
      // fragment of keys [16k, 16k + 16) is the A fragment of the k-th step
      // of P . V
      auto rescale_and_pack = [&]() {
        if (__any_sync(0xffffffffu, alpha_a != 1.f || alpha_b != 1.f)) {
#pragma unroll
          for (int i = 0; i < 64; i += 4) {
            o[i] *= alpha_a;
            o[i + 1] *= alpha_a;
            o[i + 2] *= alpha_b;
            o[i + 3] *= alpha_b;
          }
        }
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[k][e] = pack_bf16(s[8 * k + 2 * e], s[8 * k + 2 * e + 1]);
        }
      };
      // the products, issued and committed, not waited: S = Q K^T (log2-space
      // logits) over a K tile, O += P V over a V tile
      auto issue_qk = [&](const unsigned char* k_tile) {
#pragma unroll
        for (int k = 0; k < HD / 16; ++k) {
          const int half = k / 4, kk = k % 4;
          const uint64_t da = smem_desc_sw128(q_tile + half * (Q_BYTES / 2) + kk * 32, 16, 1024);
          const uint64_t db = smem_desc_sw128(k_tile + half * BOX_BYTES + kk * 32, 16, 1024);
          wgmma_m64n128k16_ss(s, da, db, k > 0);
        }
        wgmma_commit();
      };
      auto issue_pv = [&](const unsigned char* v_tile) {
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) {
          const uint64_t db = smem_desc_sw128(v_tile + k * 16 * 128, BOX_BYTES, 1024);
          wgmma_m64n128k16_rs_tb(o, p[k], db, 1);
        }
        wgmma_commit();
      };
      // a stage's K is free once S over it is done, its V once P . V over
      // it is (O and P free too): each released to the producer as soon as
      // both warpgroups are done with it
      auto release_k = [&](int st) {
        fence_regs(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(&kempty[st]);
      };
      auto release_v = [&](int st) {
        fence_regs(o);
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) fence_regs(p[k]);  // read by the wgmma until here
        __syncwarp();
        if (lane == 0) mbar_arrive(&vempty[st]);
      };
      auto advance = [&]() {
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      };

      // the first tile: S alone in this warpgroup's turn
      mbar_wait(&kfull[stage], phase);
      named_barrier_sync(BAR_TURN + wg, 256);
      wgmma_fence();
      issue_qk(sK + stage * KV_BYTES);
      named_barrier_arrive(BAR_TURN + (wg ^ 1), 256);
      wgmma_wait<0>();
      release_k(stage);
      softmax(u_begin);
      rescale_and_pack();
      int pv_stage = stage;  // the stage whose P . V is next
      uint32_t pv_phase = phase;
      advance();

      // each later tile: in one turn S of this tile, then P . V of the one
      // before; the softmax of this tile runs while P . V is in flight and
      // while the other warpgroup's products run
      for (int u = u_begin + 1; u < u_end; ++u) {
        const unsigned char* k_next = sK + stage * KV_BYTES;
        mbar_wait(&kfull[stage], phase);
        mbar_wait(&vfull[pv_stage], pv_phase);
        named_barrier_sync(BAR_TURN + wg, 256);
        wgmma_fence();
        issue_qk(k_next);
        issue_pv(sV + pv_stage * KV_BYTES);
        named_barrier_arrive(BAR_TURN + (wg ^ 1), 256);
        wgmma_wait<1>();  // S done; P . V in flight
        release_k(stage);
        softmax(u);
        wgmma_wait<0>();
        release_v(pv_stage);
        rescale_and_pack();
        pv_stage = stage;
        pv_phase = phase;
        advance();
      }

      // the last tile's P . V. Warpgroup 1's last turn of the CTA hands none
      // on: warpgroup 0 has no turn left to take
      mbar_wait(&vfull[pv_stage], pv_phase);
      named_barrier_sync(BAR_TURN + wg, 256);
      wgmma_fence();
      issue_pv(sV + pv_stage * KV_BYTES);
      if (wg == 0 || si + 1 < seg_end) named_barrier_arrive(BAR_TURN + (wg ^ 1), 256);
      wgmma_wait<0>();
      release_v(pv_stage);
      if (si + 1 < seg_end) load_q(si + 1);

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const int col0 = 2 * (lane % 4);
      if (part < 0) {  // this segment covers the row tile's keys: the output
        const float inv_a = 1.f / fmaxf(l_a, 1e-20f), inv_b = 1.f / fmaxf(l_b, 1e-20f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? rb : ra;
          if (r >= R) continue;
          const int t = r / G;
          const int g = r - t * G;
          // the lane, from the plan again: one register fewer in the unit loop
          const int lane_b = segs[si * SEG_INTS] / Hkv;
          if (LSE && lane % 4 == 0) {
            lse[((size_t)lane_b * T + t) * H + kvh * G + g] =
                half ? m_b + log2f(l_b) : m_a + log2f(l_a);
          }
          bf16* orow = out + (((size_t)lane_b * T + t) * H + kvh * G + g) * HD;
          const float inv = half ? inv_b : inv_a;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
                pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
          }
        }
      } else {  // a share of the keys: unnormalised partials for the merge
        const int la = wg * WG_ROWS + warp * 16 + lane / 4;  // row within the tile
        float* po = part_o + (size_t)part * BM * HD;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* prow = po + (size_t)(la + 8 * half) * HD;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            *reinterpret_cast<float2*>(prow + 8 * j + col0) =
                make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          }
        }
        if (lane % 4 == 0) {
          float* pml = part_ml + (size_t)part * 2 * BM;
          pml[la] = m_a;
          pml[la + 8] = m_b;
          pml[BM + la] = l_a;
          pml[BM + la + 8] = l_b;
        }
      }
    }
  }
}

// Merge of the partials of the row tiles that were split across CTAs: one
// log2-space softmax over the shares (m, l, O), then O / l in bf16.
__global__ void __launch_bounds__(HD) prefill_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ merges, bf16* __restrict__ out, float* __restrict__ lse, int T,
    int H, int Hkv, int G) {
  const int* mg = merges + blockIdx.x * MERGE_INTS;
  const int b = mg[0] / Hkv, kvh = mg[0] % Hkv;  // lane, kv head
  const int rt = mg[1], p0 = mg[2], n = mg[3];
  const int R = T * G;
  const int d = threadIdx.x;
  for (int rr = 0; rr < MERGE_ROWS; ++rr) {
    const int row = blockIdx.y * MERGE_ROWS + rr;
    const int gr = rt * BM + row;
    if (gr >= R) break;
    float m = -INFINITY;
    for (int i = 0; i < n; ++i) m = fmaxf(m, part_ml[(size_t)(p0 + i) * 2 * BM + row]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < n; ++i) {
      const float* pml = part_ml + (size_t)(p0 + i) * 2 * BM;
      const float w = exp2f(pml[row] - m);
      den += w * pml[BM + row];
      num += w * part_o[((size_t)(p0 + i) * BM + row) * HD + d];
    }
    const int t = gr / G;
    const int g = gr - t * G;
    out[(((size_t)b * T + t) * H + kvh * G + g) * HD + d] =
        __float2bfloat16(num / fmaxf(den, 1e-20f));
    if (lse != nullptr && d == 0) lse[((size_t)b * T + t) * H + kvh * G + g] = m + log2f(den);
  }
}

// Raw mode: each lane's visible arena K [vis[b], Hkv, HD] rotated from its
// per-slot duplicated-half cos/sin [C, HD] in f32, as the plain version:
// cat(k1 * c1 - k2 * s1, k2 * c2 + k1 * s2), each product and sum one IEEE
// op (no contraction into an FMA), then rounded to bf16, into k_rot [B,
// rows, Hkv, HD]. One thread per 8 column pairs of one (lane, slot, kv
// head) row; slots past the lane's visible length are left alone.
__global__ void prefill_rotate_kernel(const bf16* __restrict__ k, const float* __restrict__ cos2,
                                      const float* __restrict__ sin2, bf16* __restrict__ k_rot,
                                      const int* __restrict__ vis, int B, int rows, int Hkv,
                                      int C, long long k_lane) {
  constexpr int H2 = HD / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = i / (H2 / 8);  // over [B, rows, Hkv]
  if (row >= (long long)B * rows * Hkv) return;
  const int b = (int)(row / ((long long)rows * Hkv));
  const int in_lane = (int)(row % ((long long)rows * Hkv));
  const int slot = in_lane / Hkv;
  if (slot >= vis[b]) return;
  const int c8 = (int)(i % (H2 / 8)) * 8;
  const bf16* kr = k + b * k_lane + (size_t)in_lane * HD;
  const uint4 ua = *reinterpret_cast<const uint4*>(kr + c8);
  const uint4 ub = *reinterpret_cast<const uint4*>(kr + H2 + c8);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&ua);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&ub);
  const float* c = cos2 + ((size_t)b * C + slot) * HD;
  const float* s = sin2 + ((size_t)b * C + slot) * HD;
  float o1[8], o2[8];
#pragma unroll
  for (int e2 = 0; e2 < 4; ++e2) {
    const float2 fa = __bfloat1622float2(a2[e2]);
    const float2 fb = __bfloat1622float2(b2[e2]);
    const float a[2] = {fa.x, fa.y}, b[2] = {fb.x, fb.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 2 * e2 + h;
      o1[e] = __fsub_rn(__fmul_rn(a[h], c[c8 + e]), __fmul_rn(b[h], s[c8 + e]));
      o2[e] = __fadd_rn(__fmul_rn(b[h], c[H2 + c8 + e]), __fmul_rn(a[h], s[H2 + c8 + e]));
    }
  }
  uint4 lo, hi;
  uint32_t* wl = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* wh = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int e2 = 0; e2 < 4; ++e2) {
    wl[e2] = pack_bf16(o1[2 * e2], o1[2 * e2 + 1]);
    wh[e2] = pack_bf16(o2[2 * e2], o2[2 * e2 + 1]);
  }
  bf16* dst = k_rot + (size_t)row * HD;  // [B, rows, Hkv] row-major
  *reinterpret_cast<uint4*>(dst + c8) = lo;
  *reinterpret_cast<uint4*>(dst + H2 + c8) = hi;
}

}  // namespace

extern "C" int svt_prefill_block_rows() { return BM; }
extern "C" int svt_prefill_block_keys() { return BN; }

// K1 over B lanes. q, out [B, T, H, HD]; ka/va [B][C, Hkv, HD] with lanes
// ka_lane / va_lane elements apart; acos2/asin2 [B, C, HD] (raw mode);
// ks/vs [B, T, Hkv, HD], or both null in the full-block mode (a plan with
// no self units). plan: int32 on the device, [n_segs * 5 segments]
// [n_ctas + 1 CTA offsets][n_merges * 4 merges][B visible lengths]
// (ops/attention.py prefill_plan), vis_max the largest of the lengths. Raw
// mode (acos2 != null) rotates each lane's visible rows of ka into k_rot
// [B, vis_max, Hkv, HD] first and attends over k_rot. lse: null, or f32
// [B, T, H] for each row's log2-space log-sum-exp.
extern "C" int svt_prefill_attention(
    const void* q, const void* ka, const void* va, const void* acos2, const void* asin2,
    void* k_rot, const void* ks, const void* vs, void* out, void* part_o, void* part_ml,
    void* lse, const void* plan, int n_ctas, int n_segs, int n_merges, int B, int T, int H,
    int Hkv, int hd, int C, int vis_max, long long ka_lane, long long va_lane, void* stream) {
  if (hd != HD || Hkv <= 0 || H % Hkv != 0 || T <= 0 || n_ctas <= 0 || vis_max < 0 || B < 1 ||
      vis_max > C)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* segs = reinterpret_cast<const int*>(plan);
  const int* cta_segs = segs + n_segs * SEG_INTS;
  const int* merges = cta_segs + n_ctas + 1;
  const int* vis = merges + n_merges * MERGE_INTS;
  const uint64_t slot_stride = (uint64_t)Hkv * HD * sizeof(bf16);
  const int arena_rows = vis_max > 0 ? vis_max : 1;  // unused when 0
  if (acos2 != nullptr && vis_max > 0) {
    if (k_rot == nullptr) return (int)cudaErrorInvalidValue;
    const long long n_threads = (long long)B * vis_max * Hkv * (HD / 16);
    const int threads = 256;
    const int blocks = (int)((n_threads + threads - 1) / threads);
    prefill_rotate_kernel<<<blocks, threads, 0, st>>>(
        (const bf16*)ka, (const float*)acos2, (const float*)asin2, (bf16*)k_rot, vis, B, vis_max,
        Hkv, C, ka_lane);
    ka = k_rot;
    ka_lane = (long long)vis_max * Hkv * HD;
  }
  CUtensorMap ka_map, va_map, ks_map, vs_map;
  const uint64_t e = sizeof(bf16);
  if ((ks == nullptr) != (vs == nullptr) || (ks == nullptr && vis_max == 0))
    return (int)cudaErrorInvalidValue;
  if (!svt_tensor_map_rows(&ka_map, ka, arena_rows, Hkv, HD * e, slot_stride, BN, false, B,
                           (uint64_t)ka_lane * e) ||
      !svt_tensor_map_rows(&va_map, va, arena_rows, Hkv, HD * e, slot_stride, BN, false, B,
                           (uint64_t)va_lane * e))
    return (int)cudaErrorInvalidValue;
  if (ks == nullptr) {  // full-block mode: no self units in the plan
    ks_map = ka_map;
    vs_map = va_map;
  } else if (!svt_tensor_map_rows(&ks_map, ks, T, Hkv, HD * e, slot_stride, BN, false, B,
                                  (uint64_t)T * slot_stride) ||
             !svt_tensor_map_rows(&vs_map, vs, T, Hkv, HD * e, slot_stride, BN, false, B,
                                  (uint64_t)T * slot_stride)) {
    return (int)cudaErrorInvalidValue;
  }
  const float qscale = 1.4426950408889634f / sqrtf((float)hd);
  auto kernel = lse != nullptr ? prefill_attention_kernel<true> : prefill_attention_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  kernel<<<n_ctas, THREADS, SMEM_BYTES, st>>>(
      ka_map, va_map, ks_map, vs_map, (const bf16*)q, (bf16*)out, (float*)part_o,
      (float*)part_ml, segs, cta_segs, vis, (float*)lse, T, H, Hkv, G, qscale);
  if (n_merges > 0) {
    prefill_merge_kernel<<<dim3(n_merges, BM / MERGE_ROWS), HD, 0, st>>>(
        (const float*)part_o, (const float*)part_ml, merges, (bf16*)out, (float*)lse, T, H,
        Hkv, G);
  }
  return (int)cudaGetLastError();
}
