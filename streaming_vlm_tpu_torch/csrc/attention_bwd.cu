// Backward of causal GQA self-attention (kernel K1-bwd of the port), the
// gradient half of training's attention, written for the H100.
//
// It replaces no pl.pallas_call: the JAX package trains through XLA's
// autodiff of `_gqa_attention_chunked` (streaming_vlm_tpu/models/qwen25_vl/
// language.py:147-200). Its forward here is K1 at visible 0
// (csrc/prefill_attention.cu), which also writes each query row's log2-space
// log-sum-exp lse2; from the saved output O and lse2 this computes, for
// q [T, H, HD], k and v [T, Hkv, HD] (bf16, q and k rotated) and the output's
// gradient dO [T, H, HD] (bf16):
//   s2 = (q . k) * softmax-scale * log2(e)    (f32, from the bf16 q and k)
//   P = exp2(s2 - lse2), causal (key j <= token t)
//   D = rowsum(dO * O)                         (f32)
//   dP = dO . v, dS = P * (dP - D)             (the gradient of the natural logits)
//   dQ = dS . k * scale, dK = dS^T . q * scale, dV = P^T . dO
// with dK and dV summed over the G query heads of each kv head, f32
// accumulation and bf16 outputs. Rows are K1's packed GQA rows: row r of a
// kv head is (token r / G, head r % G), so all G heads of a kv head share
// every staged K/V tile and G is only a row count.
//
// What bounds it on an H100: operations. At T = 8192 (H 28, Hkv 4, HD 128)
// the five products over the causal half are 5 * 2 * H * HD * T (T + 1) / 2
// = 1.20 TFLOP, 1.216 ms at the bf16 tensor-core peak, against ~0.5 GB of
// inputs and outputs (0.15 ms). What the design (FA3's shape of the
// backward) does about it:
//   * the five products, each once, in one main kernel. A CTA owns one kv
//     head and a block of BN = 128 keys; K and V of the block arrive once,
//     by TMA, in K1's 128-byte swizzle. A producer warp streams row tiles
//     through a ring of STAGES stages (full / empty mbarriers, as K1's
//     ring): a tile is the packed rows of BT = 64 / G whole tokens (63 at
//     G = 7, 64 at G = 8), its Q and dO by one 4-d TMA box each half (the
//     G heads of BT tokens land in K1's row order) and its lse2 and D as one
//     512-byte bulk copy of a record the pre pass packed;
//   * two consumer warpgroups (registers rebalanced by setmaxnreg: 240
//     each, 24 for the producer warpgroup), warpgroup w owning keys
//     [64 w, 64 w + 64) of the block. Each computes S^T = K Q^T and
//     dP^T = V dO^T with wgmma (m64n64k16, both operands from shared
//     memory), forms P^T and dS^T in registers, rounded to bf16 (where
//     the plain algebra's f32 is rounded for the tensor cores), and
//     accumulates dV += P^T dO and dK += dS^T Q in registers over every
//     row tile the block sees, P^T and dS^T being exactly the register A
//     fragments of those products (m64n128k16, dO and Q read MN-major);
//   * dS also goes to shared memory (keys x rows, the layout of an MN-major
//     A operand), and the tile's dQ partial dS K (rows x 128) is the fifth
//     product, split by columns between the warpgroups. The partial (f32,
//     32 KB, its 16-byte chunks XOR-swizzled with the row) goes to a double
//     buffer, and two warps of the producer warpgroup, one a buffer, fold
//     it into an f32 accumulator in device memory by one bulk copy (the
//     first key block) or one bulk reduce-add (cp.reduce.async.bulk
//     .add.f32, the rest), so two folds are in flight;
//   * bitwise repeatable: a row tile's partials are folded in one fixed
//     order, key block 0 first, then 1, 2, ...: a per-(kv head, row tile)
//     counter, released after each fold's writes completed, makes the
//     block-n CTA wait (acquire) until it reads n. A CTA takes its job from
//     a ticket (an atomic counter), jobs in the order (key block, kv head),
//     so it waits only on the CTA of key block n - 1, which took an earlier
//     ticket and so is running: no residency of CTAs can deadlock;
//   * the makespan: every CTA visits its row tiles from the last one down
//     to the diagonal, so all the CTAs of a kv head reach a row tile at the
//     same time after their start and the block n - 1 CTA (started no
//     later) folds it first; the waits cost one chain of folds, once.
//     Tickets hand out the heaviest blocks first (block 0 sees every row
//     tile), and a freed SM takes the next block, whose share ends when
//     block 0's does (the light blocks fill the tail). Ascending tile order
//     would make block n wait at its first tile for block n - 1 to get
//     there (every CTA of a wave ending with block 0), and a descending fold
//     would launch the heaviest blocks last: tests/test_torch_bwd_plan.py
//     simulates the three;
//   * the causal edge: only the row tiles that cross the block's diagonal
//     are masked, and a weight outside the triangle is selected to 0, never
//     multiplied (0 times a stale value could be NaN). Keys past T arrive as
//     zeros from TMA's out-of-bounds fill (and are masked: they follow every
//     token); rows past T, and the rows 64 - BT G of a tile that no box
//     reaches (zeroed once), carry lse2 = +inf in the record, so P = 0;
//   * full-block mode (ring attention's blocks wholly before the queries,
//     parallel/ring.py; its own instantiation, attn_bwd_full_kernel): no
//     causal mask, so every CTA visits every row tile, from the last down
//     to the first, and no tile is masked, and all the CTAs of a kv head
//     visit the same tiles in the same order. So they run as clusters of
//     two (key blocks 2c and 2c + 1 of one kv head): each producer issues
//     half of a tile's boxes (Q's and dO's columns [64 r, 64 r + 64), lse2
//     or D of the record) by TMA multicast into both CTAs, whose full
//     barriers expect the whole tile and whose empty barriers count the
//     consumer warps of both (the peer's arriving remotely), which halves
//     the tile traffic out of L2. Each CTA folds its own dQ partial in the
//     causal mode's order (key block 0, 1, 2, ...), so a call stays
//     bitwise repeatable. Rank 0 takes the cluster's ticket and rank 1
//     reads it from rank 0's shared memory: block n waits on block n - 1,
//     its peer or the previous cluster's rank 1, which took an earlier
//     ticket and so runs, and no residency of clusters can deadlock. With
//     an odd count of key blocks the last cluster's rank 1 owns keys past T
//     only: they arrive as zeros, its partial is an exact 0 (dS . 0) and
//     its dK and dV are not stored. Summing the pair's two dQ partials in
//     distributed shared memory before the fold (half the f32 traffic into
//     L2, half the chain) was built and measured slower, whether the
//     consumers pushed their half to the peer or the fold warp read the
//     peer's (PERF.md §6). A cluster barrier ends
//     the kernel (the peer's producer writes into this CTA's shared memory
//     and its consumers arrive on its barriers until their end). O and
//     lse2 may be a larger softmax's (the ring's whole row);
//   * a pre pass computes D and packs (lse2, D) per row tile, and zeroes
//     the counters and the ticket; a post pass scales dQ, rounds it to bf16
//     and unpacks the rows. The accumulator is [Hkv, tiles, 64, 128] f32
//     (119 MB at T = 8192).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W, T = 8192 (chip_smoke.py
// phase 3, three runs): 2.86-2.92 ms of device time, 42% of the bound
// (413-421 TFLOP/s of the five products), where the first design (two
// kernels, seven products, no tensor-memory copies) took 12.57 ms;
// tools/ab_torch.py, in turns on one card: 2.86 against 12.81. SDPA's own
// backward (cuDNN) took 2.46-2.74 ms in the same runs, so this kernel is
// still 1.07-1.16x it, and aten's flash-attention backward 4.41-4.43.
// What holds it back (tools/profile_k1_bwd_torch.py): the dQ product and its fold (each
// ~0.2-0.3 ms: 3.9 GB of f32 partials reduced in L2 at 128-key blocks),
// and each warpgroup's chain of products and elementwise work per tile,
// with its registers at the limit (dK and dV take 128 of the 240).
// The full-block mode at T = 4096 over 4096 keys (same card and limit):
// 1.3038 ms of device time, 46.6% of its 0.6080 ms bound, against 1.3899
// for one CTA a block without multicast (the previous design; tools/ab_torch.py
// in turns, medians of 6: 1.4014 against 1.3053, bitwise equal outputs);
// SDPA's non-causal backward (cuDNN) took 1.2957 ms in the same
// chip_smoke.py run. What is left (tools/profile_k1_bwd_torch.py --full):
// the dQ product (~0.17 ms) and the fold (~0.06 ms).
//
// Built by nvcc for sm_90a into the port's plain-C shared library (see
// streaming_vlm_tpu_torch/ops/_kernels.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HD = 128;          // head dim (the wrapper rejects others)
constexpr int BN = 128;          // keys a CTA owns
constexpr int ROWS = 64;         // packed query rows of a row tile, at most
constexpr int CONSUMERS = 2;     // warpgroups, 64 keys each
constexpr int STAGES = 2;        // row-tile ring depth
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int KV_BYTES = BN * HD * 2;      // K or V of the block: 32 KB
constexpr int KV_BOX = KV_BYTES / 2;       // one TMA box: 64 of the 128 columns
constexpr int TILE_BYTES = ROWS * HD * 2;  // Q or dO of a row tile: 16 KB
constexpr int TILE_BOX = TILE_BYTES / 2;
constexpr int REC = 2 * ROWS;              // floats of a tile's record: lse2, then D
constexpr int DS_BYTES = BN * ROWS * 2;    // dS of a tile, keys x rows: 16 KB
constexpr int DQ_FLOATS = ROWS * HD;       // a tile's dQ partial: 32 KB of f32
constexpr size_t SMEM_BYTES = 1024 + 2 * KV_BYTES + 2 * STAGES * TILE_BYTES + 2 * DS_BYTES +
                              2 * DQ_FLOATS * 4 + STAGES * REC * 4 + 16 * sizeof(uint64_t);

static_assert(HD == 128 && BN == 128 && ROWS == 64 && CONSUMERS == 2,
              "the wgmma shapes below assume these");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0: a weight
// below 2^-126 moves no gradient in bf16 or f32 sums)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the causal limit: key j is visible to token t
__device__ __forceinline__ bool causal_ok(int key, int t) { return key <= t; }

// S^T = K Q^T (or dP^T = V dO^T): warpgroup wg's 64 keys of the block in
// kv (K or V) by the 64 rows of a staged tile (Q or dO), both K-major, as
// one wgmma group
__device__ __forceinline__ void keys_x_rows(float (&d)[32], const unsigned char* kv,
                                            const unsigned char* rows, int wg) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const int half = k / 4, kk = k % 4;
    wgmma_m64n64k16_ss<0, 0>(d, smem_desc_sw128(kv + half * KV_BOX + wg * 8192 + kk * 32, 16, 1024),
                             smem_desc_sw128(rows + half * TILE_BOX + kk * 32, 16, 1024), k > 0);
  }
  wgmma_commit();
}

// P^T = exp2(S^T * qscale - lse2) in place, each element's row's lse2 from
// the tile's record; MASKED: 0 where bit 4j + e of vis is clear (selected,
// never multiplied)
template <bool MASKED>
__device__ __forceinline__ void p_rows(float (&st)[32], const float* lse2, uint32_t vis,
                                       float qscale, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(st[4 * j + e] * qscale - ((e & 1) ? l2.y : l2.x));
      st[4 * j + e] = !MASKED || ((vis >> (4 * j + e)) & 1u) ? p : 0.f;
    }
  }
}

// dS^T = P^T (dP^T - D) in place of dP^T, each element's row's D from the
// tile's record; MASKED: 0 where bit 4j + e of vis is clear
template <bool MASKED>
__device__ __forceinline__ void ds_rows(float (&dpt)[32], const float (&pt)[32], const float* d,
                                        uint32_t vis, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(d + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ds = pt[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      dpt[4 * j + e] = !MASKED || ((vis >> (4 * j + e)) & 1u) ? ds : 0.f;
    }
  }
}

// float offset of (row, column) in a dQ partial (and in the accumulator):
// 16-byte chunk c of row r stored at chunk c ^ (r % 8)
__device__ __forceinline__ int dq_off(int r, int col) {
  return r * HD + ((((col >> 2) ^ (r & 7)) << 2) | (col & 3));
}

// The pre pass, one warp a record row (kv head, row tile, row): D =
// rowsum(dO * O) in f32 and lse2 into the tile's record, +inf and 0 for
// rows no token fills; row 0 zeroes its tile's counter, record 0 the ticket.
__global__ void attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                     const float* __restrict__ lse, float* __restrict__ rec,
                                     int* __restrict__ counters, int T, int H, int Hkv, int G,
                                     int BT, int M) {
  const int e = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= Hkv * M * ROWS) return;
  const int row = e % ROWS, tile = e / ROWS;  // tile = kvh * M + m
  const int kvh = tile / M, m = tile % M;
  const int t = m * BT + row / G, g = row % G;
  const bool ok = row < BT * G && t < T;
  float s = 0.f;
  if (ok) {
    const size_t idx = ((size_t)t * H + kvh * G + g) * HD + lane * 4;
    const uint2 a = *reinterpret_cast<const uint2*>(o + idx);
    const uint2 b = *reinterpret_cast<const uint2*>(dout + idx);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
      s += x.x * y.x + x.y * y.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    rec[(size_t)tile * REC + row] = ok ? lse[(size_t)t * H + kvh * G + g] : INFINITY;
    rec[(size_t)tile * REC + ROWS + row] = s;
    if (row == 0) counters[tile] = 0;
    if (e == 0) counters[Hkv * M] = 0;  // the ticket
  }
}

// The main kernel's body. Causal (FULL false): one job (key block, kv head)
// a CTA, taken by ticket. FULL (the full-block mode): a cluster of two CTAs
// a job (key blocks 2c and 2c + 1, kv head), taken by rank 0's ticket; the
// two share each row tile's loads (multicast).
template <bool FULL>
__device__ __forceinline__ void attn_bwd_body(
    const CUtensorMap& q_map,  // [T, Hkv, G, HD]
    const CUtensorMap& o_map,  // dO, the same
    const CUtensorMap& k_map,  // [T, Hkv, HD]
    const CUtensorMap& v_map,
    const float* __restrict__ rec,     // [Hkv, M, REC]
    int* __restrict__ counters,        // [Hkv * M] folds done a row tile, then the ticket
    float* __restrict__ dq_acc,        // [Hkv, M, ROWS, HD], dq_off layout
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hkv, int G, int BT, int M,
    float qscale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = smem;
  unsigned char* sV = sK + KV_BYTES;
  unsigned char* sQ = sV + KV_BYTES;             // [STAGES] row tiles
  unsigned char* sO = sQ + STAGES * TILE_BYTES;  // dO, [STAGES]
  unsigned char* sS = sO + STAGES * TILE_BYTES;  // dS, [2]
  float* sDQ = reinterpret_cast<float*>(sS + 2 * DS_BYTES);  // [2] dQ partials
  float* sRec = sDQ + 2 * DQ_FLOATS;                          // [STAGES] records
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sRec + STAGES * REC);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* dq_full = empty + STAGES;
  uint64_t* dq_empty = dq_full + 2;
  int* s_job = reinterpret_cast<int*>(dq_empty + 2);
  // FULL: this CTA's rank in its cluster (key block 2c + rank), the other
  // CTA's
  const uint32_t rank = FULL ? cluster_rank() : 0u, peer = rank ^ 1u;
  constexpr int PAIR = FULL ? 2 : 1;  // CTAs whose consumers read a stage

  const int rows = BT * G;  // rows a TMA box fills
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PAIR * CONSUMERS * 4);  // lane 0 of every consumer warp (of the pair)
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&dq_full[b], CONSUMERS * 4);
      mbar_init(&dq_empty[b], 1);
    }
    mbar_fence_init();
    // FULL: rank 0 takes the cluster's ticket; rank 1's word is defined
    // but never read (a job, were it read, not an address out of range)
    *s_job = rank == 0 ? atomicAdd(counters + Hkv * M, 1) : 0;
  }
  // the rows past BT G of every staged tile: no box writes them; zeros, once
  for (int i = threadIdx.x; i < 2 * STAGES * 2 * (ROWS - rows) * 8; i += THREADS) {
    const int chunk = i % 8, r = rows + (i / 8) % (ROWS - rows), box = i / (8 * (ROWS - rows));
    *reinterpret_cast<uint4*>(sQ + box * TILE_BOX + r * 128 + chunk * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  int job;
  if constexpr (FULL) {
    // both CTAs started, their barriers initialised: then each reads the
    // cluster's ticket c Hkv + kv head from rank 0, and takes key block 2c
    // + rank
    cluster_sync();
    const int ticket = ld_cluster_s32(mapa(s_job, 0));
    job = (2 * (ticket / Hkv) + (int)rank) * Hkv + ticket % Hkv;
  } else {
    __syncthreads();
    job = *s_job;
  }
  const int n = job / Hkv, kvh = job % Hkv;
  // row tiles M - 1 down to the diagonal's (full-block mode: down to 0)
  const int n_tiles = FULL ? M : M - n * BN / BT;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (wg == CONSUMERS) {
    regs_dealloc<24>();
    const int warp = (threadIdx.x % 128) / 32;
    if (warp == 0 && lane == 0) {
      // ---- producer: K and V once, then the row tiles
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&o_map);
      mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
      tma_load_4d(sK, &k_map, kv_full, 0, kvh, n * BN, 0);
      tma_load_4d(sK + KV_BOX, &k_map, kv_full, 64, kvh, n * BN, 0);
      tma_load_4d(sV, &v_map, kv_full, 0, kvh, n * BN, 0);
      tma_load_4d(sV + KV_BOX, &v_map, kv_full, 64, kvh, n * BN, 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int m = M - 1 - i;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 4 * rows * 128 + REC * 4);
        unsigned char* q_dst = sQ + stage * TILE_BYTES;
        unsigned char* o_dst = sO + stage * TILE_BYTES;
        const float* rec_m = rec + (size_t)(kvh * M + m) * REC;
        if constexpr (FULL) {
          // half the boxes, into both CTAs: columns [64 rank, 64 rank + 64)
          // of Q and dO, and lse2 (rank 0) or D (rank 1) of the record
          const int c0 = 64 * (int)rank;
          tma_load_4d_multicast(q_dst + rank * TILE_BOX, &q_map, &full[stage], c0, 0, kvh,
                                m * BT, 0b11);
          tma_load_4d_multicast(o_dst + rank * TILE_BOX, &o_map, &full[stage], c0, 0, kvh,
                                m * BT, 0b11);
          bulk_load_multicast(sRec + stage * REC + rank * ROWS, rec_m + rank * ROWS, ROWS * 4,
                              &full[stage], 0b11);
        } else {
          tma_load_4d(q_dst, &q_map, &full[stage], 0, 0, kvh, m * BT);
          tma_load_4d(q_dst + TILE_BOX, &q_map, &full[stage], 64, 0, kvh, m * BT);
          tma_load_4d(o_dst, &o_map, &full[stage], 0, 0, kvh, m * BT);
          tma_load_4d(o_dst + TILE_BOX, &o_map, &full[stage], 64, 0, kvh, m * BT);
          bulk_load(sRec + stage * REC, rec_m, REC * 4, &full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if ((warp == 1 || warp == 2) && lane == 0) {
      // ---- the dQ fold, warp 1 for buffer 0 (even tiles), warp 2 for
      // buffer 1: key block 0 stores, block n adds once the row tile's
      // counter reads n (FULL: block n - 1 is the peer, or the previous
      // cluster's rank 1, which took an earlier ticket)
      const int b = warp - 1;
      for (int i = b; i < n_tiles; i += 2) {
        const int m = M - 1 - i;
        int* cnt = counters + kvh * M + m;
        float* dst = dq_acc + (size_t)(kvh * M + m) * DQ_FLOATS;
        const float* src = sDQ + b * DQ_FLOATS;
        // the turn first (block n - 1 is ahead: this read seldom waits)
        while (n > 0 && ld_acquire(cnt) != n) {
        }
        mbar_wait(&dq_full[b], (i >> 1) & 1);
        if (n == 0) {
          bulk_store(dst, src, DQ_FLOATS * 4);
        } else {
          fence_proxy_async_global();
          bulk_reduce_add_f32(dst, src, DQ_FLOATS * 4);
        }
        bulk_commit();
        bulk_wait_all();  // the adds are done: the next block's turn
        fence_proxy_async_global();
        red_release_add(cnt, 1);
        mbar_arrive(&dq_empty[b]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys n BN + [64 wg, 64 wg + 64)
    regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int key_a = n * BN + wg * 64 + warp * 16 + lane / 4, key_b = key_a + 8;
    const int kl_a = key_a - n * BN;  // the thread's first key within the block
    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;

    for (int i = 0; i < n_tiles; ++i) {
      const int m = M - 1 - i, t0 = m * BT, b = i & 1;
      const unsigned char* q_t = sQ + stage * TILE_BYTES;
      const unsigned char* o_t = sO + stage * TILE_BYTES;
      const float* rec_t = sRec + stage * REC;
      unsigned char* ds_t = sS + b * DS_BYTES;

      // S^T = K Q^T and dP^T = V dO^T: [this warpgroup's 64 keys, 64 rows]
      float st[32], dpt[32];
      mbar_wait(&full[stage], phase);
      keys_x_rows(st, sK, q_t, wg);
      keys_x_rows(dpt, sV, o_t, wg);

      // element 4j + e of S^T / dP^T is key (e & 2 ? b : a), row 8j + 2
      // (lane % 4) + (e & 1) of the tile (token t0 + row / G); only the tiles
      // that cross the block's diagonal are masked: bit 4j + e of `vis`
      const bool diag = !FULL && n * BN + BN - 1 > t0;
      uint32_t vis = ~0u;
      if (diag) {
        vis = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * (lane % 4) + (e & 1);
            if (causal_ok((e & 2) ? key_b : key_a, t0 + c / G)) vis |= 1u << (4 * j + e);
          }
        }
      }
      // P^T in place of S^T, then in bf16: the fragment of rows [16 kk,
      // 16 kk + 16) is the A fragment of the kk-th step of dV += P^T dO,
      // issued at once (it runs while dS is formed)
      wgmma_wait<1>();
      fence_regs(st);
      if (diag) {
        p_rows<true>(st, rec_t, vis, qscale, lane);
      } else {
        p_rows<false>(st, rec_t, vis, qscale, lane);
      }
      uint32_t pa[ROWS / 16][4], da[ROWS / 16][4];
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        wgmma_m64n128k16_rs_tb(dva, pa[kk], smem_desc_sw128(o_t + kk * 2048, TILE_BOX, 1024), 1);
      }
      wgmma_commit();

      // dS^T = P^T (dP^T - D) in place of dP^T (0 where P is masked), in
      // bf16 the A fragments of dK += dS^T Q
      wgmma_wait<1>();
      fence_regs(dpt);
      if (diag) {
        ds_rows<true>(dpt, st, rec_t + ROWS, vis, lane);
      } else {
        ds_rows<false>(dpt, st, rec_t + ROWS, vis, lane);
      }
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) da[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
      }
      // dS as keys x rows (each key's 64 rows one 128-byte swizzled line):
      // the MN-major A operand of dQ = dS K; da[kk][e] holds rows 16 kk +
      // 8 (e / 2) + 2 (lane % 4), +1 of key (e & 1 ? b : a). Announced to
      // the other warpgroup on barrier 1 + 2 wg + b, without waiting
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kl_a + 8 * (e & 1);
          const int c = 16 * kk + 8 * (e >> 1) + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(ds_t + kl * 128 + (((c >> 3) ^ (kl & 7)) << 4) +
                                       ((c & 7) << 1)) = da[kk][e];
        }
      }
      fence_proxy_async();
      named_barrier_arrive(1 + 2 * wg + b, CONSUMERS * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        wgmma_m64n128k16_rs_tb(dka, da[kk], smem_desc_sw128(q_t + kk * 2048, TILE_BOX, 1024), 1);
      }
      wgmma_commit();

      // the dQ partial dS K over this warpgroup's 64 columns (K MN-major),
      // once the other warpgroup's half of dS is in place
      named_barrier_sync(1 + 2 * (1 - wg) + b, CONSUMERS * 128);
      float dq[32];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_m64n64k16_ss<1, 1>(dq, smem_desc_sw128(ds_t + kk * 2048, 16, 1024),
                                 smem_desc_sw128(sK + wg * KV_BOX + kk * 2048, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dva);
      fence_regs(dka);
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        fence_regs(pa[kk]);  // read by the wgmma until here
        fence_regs(da[kk]);
      }
      __syncwarp();
      if (lane == 0) {  // this stage's Q and dO are read (FULL: the peer's producer also fills it)
        mbar_arrive(&empty[stage]);
        if constexpr (FULL) mbar_arrive_cluster(mapa(&empty[stage], peer));
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(dq);

      // the partial -> the fold's buffer b (free once its last fold is done)
      mbar_wait(&dq_empty[b], ((i >> 1) & 1) ^ 1);
      float* sdq = sDQ + b * DQ_FLOATS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wg * 64 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(sdq + dq_off(r, col)) =
              make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&dq_full[b]);
    }

    // dK (times the softmax scale) and dV of this thread's two keys
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = h ? key_b : key_a;
      if (key >= T) continue;
      bf16* krow = dk + ((size_t)key * Hkv + kvh) * HD + 2 * (lane % 4);
      bf16* vrow = dv + ((size_t)key * Hkv + kvh) * HD + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) =
            pack_bf16(dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) = pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
  // FULL: the peer's producer writes into this CTA's shared memory and its
  // consumers arrive on this CTA's barriers until their own end
  if constexpr (FULL) cluster_sync();
}

__global__ void __launch_bounds__(THREADS, 1) attn_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap o_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ rec, int* __restrict__ counters, float* __restrict__ dq_acc,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hkv, int G, int BT, int M,
    float qscale, float scale) {
  attn_bwd_body<false>(q_map, o_map, k_map, v_map, rec, counters, dq_acc, dk, dv, T, Hkv, G, BT,
                       M, qscale, scale);
}

// The full-block mode: clusters of two CTAs, ceil(blocks / 2) a kv head.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1) attn_bwd_full_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap o_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ rec, int* __restrict__ counters, float* __restrict__ dq_acc,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hkv, int G, int BT, int M,
    float qscale, float scale) {
  attn_bwd_body<true>(q_map, o_map, k_map, v_map, rec, counters, dq_acc, dk, dv, T, Hkv, G, BT,
                      M, qscale, scale);
}

// The post pass: dQ = the accumulator times the softmax scale, in bf16,
// unpacked to [T, H, HD]; one thread 8 columns of a (token, head) row.
__global__ void attn_bwd_dq_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int T,
                                   int H, int G, int BT, int M, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * H * (HD / 8)) return;
  const int row = (int)(i / (HD / 8)), c8 = (int)(i % (HD / 8));
  const int t = row / H, h = row % H;
  const int kvh = h / G, g = h % G, m = t / BT;
  const int r = (t - m * BT) * G + g;
  const float* src = dq_acc + (size_t)(kvh * M + m) * DQ_FLOATS;
  const float4 a = *reinterpret_cast<const float4*>(src + dq_off(r, 8 * c8));
  const float4 b = *reinterpret_cast<const float4*>(src + dq_off(r, 8 * c8 + 4));
  uint4 w;
  w.x = pack_bf16(a.x * scale, a.y * scale);
  w.y = pack_bf16(a.z * scale, a.w * scale);
  w.z = pack_bf16(b.x * scale, b.y * scale);
  w.w = pack_bf16(b.z * scale, b.w * scale);
  *reinterpret_cast<uint4*>(dq + (size_t)row * HD + c8 * 8) = w;
}

}  // namespace

extern "C" int svt_attention_bwd_block_keys() { return BN; }
extern "C" int svt_attention_bwd_tile_rows() { return ROWS; }

// The full-block mode's launch shape on the current device: the CTAs of a
// cluster (compiled in) and how many such clusters can be resident at once.
extern "C" int svt_attention_bwd_clusters(int* width, int* resident) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, attn_bwd_full_kernel);
  if (e != cudaSuccess) return (int)e;
  *width = a.requiredClusterWidth;
  cudaFuncSetAttribute(attn_bwd_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.requiredClusterWidth, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  return (int)cudaOccupancyMaxActiveClusters(resident, attn_bwd_full_kernel, &cfg);
}

// K1-bwd. q, o, dout, dq [T, H, HD]; k, v, dk, dv [T, Hkv, HD] (bf16,
// contiguous); lse [T, H] f32 (log2 space, as K1 writes it). Scratch (the
// wrapper's, see ops/attention.py `attention_bwd_tiles`): rec f32
// [Hkv, M, 128], counters int32 [Hkv M + 1], dq_acc f32 [Hkv, M, 64, HD],
// M = ceil(T / (64 / G)) row tiles. full_block: the full-block mode (no
// causal mask). Three launches on `stream`.
extern "C" int svt_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* lse, const void* dout, void* rec, void* counters,
                                 void* dq_acc, void* dq, void* dk, void* dv, int T, int H, int Hkv,
                                 int hd, int full_block, void* stream) {
  if (hd != HD || Hkv <= 0 || H % Hkv != 0 || T <= 0 || H / Hkv > ROWS)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int BT = ROWS / G, M = (T + BT - 1) / BT, NB = (T + BN - 1) / BN;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)hd);
  const float qscale = 1.4426950408889634f * scale;
  CUtensorMap q_map, o_map, k_map, v_map;
  const uint64_t slot = (uint64_t)Hkv * HD * sizeof(bf16);
  if (!svt_tensor_map_gqa(&q_map, q, T, Hkv, G, BT) ||
      !svt_tensor_map_gqa(&o_map, dout, T, Hkv, G, BT) ||
      !svt_tensor_map_rows(&k_map, k, T, Hkv, HD * sizeof(bf16), slot, BN) ||
      !svt_tensor_map_rows(&v_map, v, T, Hkv, HD * sizeof(bf16), slot, BN))
    return (int)cudaErrorInvalidValue;
  const int records = Hkv * M * ROWS;
  attn_bwd_prep_kernel<<<(records + 7) / 8, 256, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (const float*)lse, (float*)rec, (int*)counters, T, H,
      Hkv, G, BT, M);
  if (full_block) {
    cudaFuncSetAttribute(attn_bwd_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM_BYTES);
    attn_bwd_full_kernel<<<Hkv * 2 * ((NB + 1) / 2), THREADS, SMEM_BYTES, st>>>(
        q_map, o_map, k_map, v_map, (const float*)rec, (int*)counters, (float*)dq_acc, (bf16*)dk,
        (bf16*)dv, T, Hkv, G, BT, M, qscale, scale);
  } else {
    cudaFuncSetAttribute(attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM_BYTES);
    attn_bwd_kernel<<<Hkv * NB, THREADS, SMEM_BYTES, st>>>(
        q_map, o_map, k_map, v_map, (const float*)rec, (int*)counters, (float*)dq_acc, (bf16*)dk,
        (bf16*)dv, T, Hkv, G, BT, M, qscale, scale);
  }
  const long long threads = (long long)T * H * (HD / 8);
  attn_bwd_dq_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const float*)dq_acc, (bf16*)dq, T, H, G, BT, M, scale);
  return (int)cudaGetLastError();
}
