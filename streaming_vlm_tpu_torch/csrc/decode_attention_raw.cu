// Single-token decode attention over the RAW (un-rotated) arena, read in its
// storage form, + the decode delta + self, under one joint softmax: kernel
// K3 of the port.
//
// Replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_decode_attention_int8` / `_decode_int8_kernel`. The arena K/V
// are either int8 with per-(slot, kv head) f32 scales or bf16 (one template,
// QUANT); each slot's mRoPE angles are built in the kernel from its [3]
// positions and the [3, HD/2] masked inverse-frequency table:
//   ang[c, ch] = pos[c,0] * f0[ch] + pos[c,1] * f1[ch] + pos[c,2] * f2[ch]
// (two of the three terms are exact zeros, so the kernel computes it as the
// single product that the plain version computes), and K is rotated with
// the duplicated-half convention (channel ch pairs with ch + HD/2).
//
// Dtype chain, as the plain version (dequantize to the compute dtype, then
// rotate in f32, then cast): k = bf16(q8 * s) -> r = bf16(k1*cos - k2*sin,
// k2*cos + k1*sin) with each product and sum rounded separately (no FMA
// contraction, as PyTorch's elementwise ops) -> dot with the bf16 query
// (exact products, f32 sums), scaled by softmax-scale * log2(e) after.
// V is bf16(q8 * s). sin/cos are `sincosf` with full range reduction: append
// mode grows positions without bound, and the fast intrinsics' error grows
// with |x|.
//
// What bounds it on an H100. Bytes: at visible_len = 9000 an int8 arena
// layer is 9000 x 4 x 128 x 2 B of K+V plus 288 KB of scales and 108 KB of
// positions, ~9.6 MB, 2.9 us at 3.35 TB/s. The f32 work that the dtype
// chain keeps off the tensor cores is of the same order by its count of
// operations (per slot and kv head 64 sincosf, 128 + 128 dequantizations,
// 64 rotations and 7 x 128 P.V FMAs: ~2.3 us at the card's 67 TFLOP/s),
// but as instructions it is several times that (conversions, byte
// extraction, rounding, sincosf's range reduction), and on the card the
// kernel is bound by issuing them and by their latency, not by bytes.
// The design keeps the bytes in flight, spreads that work over the whole
// card and keeps it off the critical path where it can (split-K flash
// decoding in one launch, as K2):
//   * grid (parts, kv heads, lanes): a part is one split of `split`
//     consecutive visible slots (the host picks `split` from the lanes'
//     largest visible_len so that the grid fills one wave of the card:
//     ops/attention.py `decode_split_size`), or the small block of delta +
//     self rows, which runs beside the arena splits as one more partial.
//     The lane form serves B streams in one launch, as K2's: lane b reads
//     its own arena, scales, positions, queries, small block and visible
//     length (an int32 device array), and a split past its length exits
//     before it touches memory;
//   * staging: thread 0 first bulk-copies the small operands (the kv
//     head's queries, the frequency table, the split's positions and all
//     kv heads' K/V scale rows) on their own mbarrier, then the K and V
//     rows of its kv head by TMA, one box of 40 rows per 128-byte plane
//     (an int8 row is one plane, a bf16 row two) and per mbarrier, in the
//     128-byte swizzle, so that Q.K starts on the first chunk while the
//     rest are in flight;
//   * Q.K on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums):
//     A = the unscaled bf16 queries, B = the dequantized, rotated K rows,
//     the logits scaled after; a warp takes 4 rows at a time, and each
//     lane dequantizes, computes the sin/cos of and rotates its 8 channel
//     pairs of one row in registers, so each (slot, kv head, pair) is done
//     once and no rotated K is written anywhere. The swizzle makes those
//     fragment reads conflict-free. The small block's rows are bf16 and
//     already rotated;
//   * P.V in f32 on the CUDA cores (P in bf16 would leave the decode
//     tolerance): thread t owns head dims 2 (t % 64) + {0, 1} of every 4th
//     group of 4 rows and dequantizes its V values as it reads them;
//   * the combine is fused (decode_common.cuh `finish_part`): the last CTA
//     of each kv head folds the parts' partials and resets its counter.
// The arena's sin/cos are computed once per kv head (4x per slot at Hkv =
// 4). Measured alternatives that lost on the card: a cluster of a split's
// kv-head CTAs sharing one sin/cos table through distributed shared memory
// (not all clusters were resident at once), a fold in two levels, and
// per-row bulk copies (the SM's copy engine queued 576 small requests).

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int HALF = HD / 2;
constexpr int TILE = 160;               // rows staged at once: the largest split
constexpr int LINE = 128;               // bytes of one staged row of a plane
constexpr int PLANE = TILE * LINE;      // a tile of one plane: int8 rows, or half of each bf16 row
constexpr int CHUNKS = 4;               // a tile arrives in chunks of TILE / CHUNKS rows,
constexpr int CHUNK = TILE / CHUNKS;    // one TMA box per plane and one mbarrier each
constexpr int GROUP = 4;                // rows of a warp's Q.K step (half an mma's n)
constexpr size_t K3_SMEM = 1024                                         // alignment slack
                           + 4 * (size_t)PLANE                          // K, V tiles, 2 planes each
                           + sizeof(float) * GMAX * TILE                // logits, then weights
                           + sizeof(float) * 3 * TILE                   // positions
                           + sizeof(float) * 2 * GMAX * TILE            // K and V scales, all kv heads
                           + sizeof(float) * 4 * GMAX                   // m, l, alpha, den
                           + sizeof(float) * 3 * HALF                   // inverse frequencies
                           + sizeof(bf16) * GMAX * HD                   // the kv head's queries
                           + sizeof(uint64_t) * (CHUNKS + 1);           // mbarriers
// the fused combine keeps one weight per (query head, part) in the K tile
constexpr int MAX_PARTS = 2 * PLANE / (GMAX * (int)sizeof(float));

static_assert(CHUNK % GROUP == 0 && (CHUNK * LINE) % 1024 == 0,
              "a group of rows lies in one chunk, and chunks keep the swizzle's 8-row atoms");
static_assert(EMAX <= 2 * TILE, "the small block must fit in two tiles");
static_assert(QUARTERS * GMAX * HD * sizeof(float) <= 2 * PLANE, "reduction fits in a tile");
static_assert(GMAX == 8, "a query head per mma row g");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// signed byte k (0..3) of a 32-bit word
__device__ __forceinline__ float s8(uint32_t w, int k) {
  return (float)(((int32_t)(w << (24 - 8 * k))) >> 24);
}

// two bf16 values (exact in f32) as one .b32 mma operand, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte b (< LINE) of staged row j of a plane, as the TMA's 128-byte swizzle
// lays it out: 16-byte chunk b / 16 of the row is stored at chunk (b / 16)
// XOR (j % 8).
__device__ __forceinline__ int swz(int j, int b) {
  return j * LINE + ((((b >> 4) ^ j) & 7) << 4) + (b & 15);
}

// channels {d, d + 1} of staged bf16 row j (two planes of 64 channels)
__device__ __forceinline__ float2 bf16_pair(const unsigned char* tile, int j, int d) {
  const unsigned char* p = tile + (d >> 6) * PLANE + swz(j, 2 * (d & 63));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Channels {d, d + 1, d + 8, d + 9} (d even, d % 16 < 8) of staged K row
// j in storage form, dequantized to bf16 values (held as f32).
template <bool QUANT>
__device__ __forceinline__ void k_values(const unsigned char* tile, int j, int d, float scale,
                                         float (&k)[4]) {
  if constexpr (QUANT) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(tile + swz(j, d)) |
                       (uint32_t)*reinterpret_cast<const uint16_t*>(tile + swz(j, d + 8)) << 16;
#pragma unroll
    for (int e = 0; e < 4; ++e) k[e] = round_bf16(__fmul_rn(s8(w, e), scale));
  } else {
    const float2 a = bf16_pair(tile, j, d), b = bf16_pair(tile, j, d + 8);
    k[0] = a.x;
    k[1] = a.y;
    k[2] = b.x;
    k[3] = b.y;
  }
}

// One split of the raw arena (or the small block) of one kv head -> its
// partial; the last CTA of the kv head folds them into out [H, HD].
template <bool QUANT>
__global__ void __launch_bounds__(DEC_THREADS, 2) decode_raw_kernel(
    const __grid_constant__ CUtensorMap k_map,    // arena K [B][C, Hkv, HD] in storage form
    const __grid_constant__ CUtensorMap v_map,    // arena V
    const __grid_constant__ CUtensorMap ksm_map,  // [B, E1, Hkv, HD] rotated delta ++ self rows
    const __grid_constant__ CUtensorMap vsm_map,
    const bf16* __restrict__ q,       // [B, H, HD]
    const float* __restrict__ ks,     // [B][C, Hkv] K scales (QUANT), lanes s_lane apart
    const float* __restrict__ vs,     // [B][C, Hkv] V scales (QUANT)
    const float* __restrict__ pos,    // [B, C, 3] f32 per-slot mRoPE positions
    const float* __restrict__ freqs,  // [3, HALF] masked inverse frequencies
    float* __restrict__ part_m,       // [B * Hkv, gridDim.x, G]
    float* __restrict__ part_l,       // [B * Hkv, gridDim.x, G]
    float* __restrict__ part_acc,     // [B * Hkv, gridDim.x, G, HD]
    int* __restrict__ counters,       // [B * Hkv], zero between calls
    bf16* __restrict__ out,           // [B, H, HD]
    const int* __restrict__ vis_lanes,  // [B] visible lengths, or null: vis_host for all
    int vis_host, long long s_lane, int C, int Hkv, int G, int split_rows, int e1, int e_delta,
    int extra_visible, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // [2][TILE] lines of K
  unsigned char* sv = sk + 2 * PLANE;                        // [2][TILE] lines of V
  float* sp = reinterpret_cast<float*>(sv + 2 * PLANE);      // [GMAX][TILE]
  float* s_pos = sp + GMAX * TILE;                           // [TILE][3]
  float* s_ks = s_pos + 3 * TILE;                            // [TILE][Hkv]
  float* s_vs = s_ks + GMAX * TILE;                          // [TILE][Hkv]
  float* s_m = s_vs + GMAX * TILE;                           // running max per query head
  float* s_l = s_m + GMAX;
  float* s_alpha = s_l + GMAX;
  float* s_den = s_alpha + GMAX;
  float* s_freq = s_den + GMAX;                              // [3][HALF]
  bf16* sq = reinterpret_cast<bf16*>(s_freq + 3 * HALF);     // [G][HD]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sq + GMAX * HD);  // the chunks', then the operands'
  uint64_t* bar_ops = bar + CHUNKS;
  __shared__ int s_last;

  const int kvh = blockIdx.y, b = blockIdx.z;  // kv head, lane
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this lane's splits; the grid holds the lanes' largest count + the small block
  const int visible_len = lane_visible(vis_lanes, vis_host, b, (gridDim.x - 1) * split_rows);
  const int n_splits = (visible_len + split_rows - 1) / split_rows;
  const bool small = blockIdx.x == gridDim.x - 1;  // the delta + self rows: bf16, already rotated
  if (!small && (int)blockIdx.x >= n_splits) return;  // past this lane's visible slots
  const int part = small ? n_splits : blockIdx.x;      // the partial's slot
  // the slot and the lane's part count wait in shared memory for finish_part
  // (registers live across the loops cost this kernel spills)
  __shared__ int s_slot[2];
  if (threadIdx.x == 0) {
    s_slot[0] = part;
    s_slot[1] = n_splits + 1;
  }
  const size_t H = (size_t)Hkv * G;
  q += b * H * HD;
  pos += (size_t)b * C * 3;
  if (QUANT) {
    ks += b * s_lane;
    vs += b * s_lane;
  }
  const bool quant = QUANT && !small;   // rows in int8 with scales
  const int planes = quant ? 1 : 2;     // an int8 row is one line, a bf16 row two

  // the rows of this part: arena slots [row0, row0 + rows), or k_small [0, e1)
  const CUtensorMap* km = small ? &ksm_map : &k_map;
  const CUtensorMap* vm = small ? &vsm_map : &v_map;
  const int row0 = small ? 0 : part * split_rows;
  const int rows = small ? e1 : min(split_rows, visible_len - row0);

  // stage a tile's K and V rows: per chunk of CHUNK rows one TMA box per
  // plane of each (rows past the part's end arrive too, masked below)
  auto stage_tile = [&](int t0, int n) {
    if (tid == 0) {
      for (int c = 0; c * CHUNK < n; ++c) {
        mbar_arrive_expect_tx(&bar[c], 2u * planes * CHUNK * LINE);
        for (int p = 0; p < planes; ++p) {
          const int off = p * PLANE + c * CHUNK * LINE;
          tma_load_4d(sk + off, km, &bar[c], 64 * p, kvh, row0 + t0 + c * CHUNK, b);
          tma_load_4d(sv + off, vm, &bar[c], 64 * p, kvh, row0 + t0 + c * CHUNK, b);
        }
      }
    }
  };
  // the small operands go first, one bulk copy each, on their own barrier:
  // the kv head's queries, the frequencies, and an arena split's positions
  // and K/V scales (all kv heads' rows [row0, row0 + rows4), where they
  // lie inside the arena and the lane's rows are 16-byte aligned; else
  // plain loads below)
  const int rows4 = (rows + 3) & ~3;
  const bool bulk_rows = !small && row0 + rows4 <= C && (b == 0 || (C % 4 == 0 && s_lane % 4 == 0));
  if (tid == 0) {
    for (int c = 0; c <= CHUNKS; ++c) mbar_init(&bar[c], 1);
    mbar_fence_init();
    const uint32_t row_bytes = bulk_rows ? rows4 * 3 * 4 + (QUANT ? 2 * rows4 * Hkv * 4 : 0) : 0;
    mbar_arrive_expect_tx(bar_ops, G * HD * 2 + 3 * HALF * 4 + row_bytes);
    bulk_load(sq, q + (size_t)kvh * G * HD, G * HD * 2, bar_ops);
    bulk_load(s_freq, freqs, 3 * HALF * 4, bar_ops);
    if (bulk_rows) {
      bulk_load(s_pos, pos + (size_t)row0 * 3, rows4 * 3 * 4, bar_ops);
      if (QUANT) {
        bulk_load(s_ks, ks + (size_t)row0 * Hkv, rows4 * Hkv * 4, bar_ops);
        bulk_load(s_vs, vs + (size_t)row0 * Hkv, rows4 * Hkv * 4, bar_ops);
      }
    }
    if (rows > 0) stage_tile(0, min(TILE, rows));
  }
  if (!small && !bulk_rows) {  // a split at the end of an arena of C % 4 != 0 slots, or unaligned lanes
    for (int i = tid; i < 3 * rows; i += DEC_THREADS) s_pos[i] = pos[(size_t)row0 * 3 + i];
    for (int i = tid; QUANT && i < rows * Hkv; i += DEC_THREADS) {
      s_ks[i] = ks[(size_t)row0 * Hkv + i];
      s_vs[i] = vs[(size_t)row0 * Hkv + i];
    }
  }
  if (tid < GMAX) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  // Q.K as mma m16n8k16 over groups of 4 rows: A = the unscaled bf16
  // queries (row g = query head g; rows G.. and 8.. zero), B = K^T (the
  // group's 4 rows twice: lane l supplies row l / 4 % 4, as column l / 4);
  // the f32 logits are scaled after (bf16 products are exact in f32).
  // Lane l = 4 g + t owns head dims d = 16 c + 2 t + {0, 1, 8, 9} of its
  // row and d + HALF, for c in {0, 1} (g < 4) or {2, 3} (g >= 4): both
  // halves of its 8 channel pairs, dequantized and rotated in registers.
  // Each 16-dim slice is one mma whose other half of the columns is zero,
  // so columns n and n + 4 hold row n's sums over the two lanes' slices.
  // The angle is the one product pos[axis(ch)] * inv_freq[ch] of the
  // table's nonzero row.
  const int lg = lane / 4, lt = lane % 4;
  const int lrow = lg % 4, lhalf = lg / 4;  // the lane's row in the group, its slices
  float acc[GMAX][2];
#pragma unroll
  for (int h = 0; h < GMAX; ++h) acc[h][0] = acc[h][1] = 0.f;
  const int dp = tid % (HD / 2), quarter = tid / (HD / 2);
  __syncthreads();
  mbar_wait(bar_ops, 0);
  uint32_t qa[HD / 16][4];  // A fragments, one per 16 head dims
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const bf16* qh = sq + lg * HD + 16 * c + 2 * lt;
    qa[c][0] = lg < G ? *reinterpret_cast<const uint32_t*>(qh) : 0u;
    qa[c][2] = lg < G ? *reinterpret_cast<const uint32_t*>(qh + 8) : 0u;
    qa[c][1] = qa[c][3] = 0u;
  }

  // the lane's channels' inverse frequencies and mRoPE axes (2 bits each)
  float inv[2][4];
  uint32_t axes = 0;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 16 * (2 * lhalf + cc) + 2 * lt + (e & 1) + 8 * (e >> 1);
      const float f0 = s_freq[ch], f1 = s_freq[HALF + ch], f2 = s_freq[2 * HALF + ch];
      inv[cc][e] = f0 + f1 + f2;  // two of them are zeros
      axes |= (f0 != 0.f ? 0u : f1 != 0.f ? 1u : 2u) << (2 * (4 * cc + e));
    }
  }

  uint32_t parity = 0;
  for (int t0 = 0; t0 < rows; t0 += TILE) {
    const int n = min(TILE, rows - t0);
    const int n4 = (n + 3) / 4 * 4;
    if (t0 > 0) stage_tile(t0, n);

    // logits: warp w takes the groups of 4 rows starting at 4 (w + 8 i)
    for (int j0 = GROUP * warp; j0 < n; j0 += GROUP * DEC_WARPS) {
      mbar_wait(&bar[j0 / CHUNK], parity);
      const int j = j0 + lrow;  // this lane's row
      const bool valid = j < n;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, kscale = 1.f;
      if (valid && !small) {
        p0 = s_pos[3 * j];
        p1 = s_pos[3 * j + 1];
        p2 = s_pos[3 * j + 2];
        kscale = QUANT ? s_ks[j * Hkv + kvh] : 1.f;
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 2 * lhalf + cc;
        const int dd = 16 * c + 2 * lt;
        float k1[4] = {0.f, 0.f, 0.f, 0.f}, k2[4] = {0.f, 0.f, 0.f, 0.f};  // dims dd.., dd + HALF..
        if (valid) {
          if (small) {
            k_values<false>(sk, j, dd, 1.f, k1);
            k_values<false>(sk, j, dd + HALF, 1.f, k2);
          } else {
            k_values<QUANT>(sk, j, dd, kscale, k1);
            k_values<QUANT>(sk, j, dd + HALF, kscale, k2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t axis = (axes >> (2 * (4 * cc + e))) & 3u;
              const float ang = __fmul_rn(axis == 0 ? p0 : axis == 1 ? p1 : p2, inv[cc][e]);
              float sn, cs;
              sincosf(ang, &sn, &cs);
              const float x1 = k1[e], x2 = k2[e];
              k1[e] = round_bf16(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)));
              k2[e] = round_bf16(__fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn)));
            }
          }
        }
        const uint32_t b1[2] = {pack_bf16(k1[0], k1[1]), pack_bf16(k1[2], k1[3])};
        const uint32_t b2[2] = {pack_bf16(k2[0], k2[1]), pack_bf16(k2[2], k2[3])};
        __syncwarp();  // the lanes of a row past n rejoin before the mma
        // slice cc of the lower lanes' rows, then slice 2 + cc of the upper lanes'
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool mine = lhalf == h;
          mma_m16n8k16_bf16(d, qa[2 * h + cc], mine ? b1[0] : 0u, mine ? b1[1] : 0u);
          mma_m16n8k16_bf16(d, qa[2 * h + cc + HALF / 16], mine ? b2[0] : 0u, mine ? b2[1] : 0u);
        }
      }
      // d[0], d[1]: query head lg, columns 2 lt + {0, 1}; row r's logit is
      // columns r and r + 4, held by lanes lt and lt + 2
      const float l0 = d[0] + __shfl_xor_sync(0xffffffffu, d[0], 2);
      const float l1 = d[1] + __shfl_xor_sync(0xffffffffu, d[1], 2);
      if (lg < G && lt < 2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jr = j0 + 2 * lt + e;
          const int jj = t0 + jr;  // row within the part
          const bool vis = jr < n && (!small || jj < extra_visible || jj >= e_delta);
          sp[lg * TILE + jr] = vis ? (e ? l1 : l0) * qscale : -INFINITY;
        }
      }
    }
    // every chunk has landed (a warp with no rows in one has not waited on it)
    for (int c = 0; c * CHUNK < n; ++c) mbar_wait(&bar[c], parity);
    parity ^= 1;
    __syncthreads();

    // softmax of query head g over the tile, online across tiles: warp g
    if (warp < G) {
      const int g = warp;
      float mx = -INFINITY;
      for (int j = lane; j < n4; j += 32) mx = fmaxf(mx, sp[g * TILE + j]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no visible row yet: subtract 0
      float sum = 0.f;
      for (int j = lane; j < n4; j += 32) {
        const float p = exp2f(sp[g * TILE + j] - base);
        sp[g * TILE + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - base);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: head dims 2 dp + {0, 1} of the groups of 4 rows starting at
    // 4 (quarter + 4 i), V dequantized as it is read
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float a = g < G ? s_alpha[g] : 0.f;
      acc[g][0] *= a;
      acc[g][1] *= a;
    }
    for (int j0 = 4 * quarter; j0 < n; j0 += 4 * QUARTERS) {
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
        v[r] = make_float2(0.f, 0.f);
        if (j < n) {
          if (quant) {
            const uint32_t w = *reinterpret_cast<const uint16_t*>(sv + swz(j, 2 * dp));
            const float vsc = s_vs[j * Hkv + kvh];
            v[r] = make_float2(round_bf16(__fmul_rn(s8(w, 0), vsc)),
                               round_bf16(__fmul_rn(s8(w, 1), vsc)));
          } else {
            v[r] = bf16_pair(sv, j, 2 * dp);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(sp + g * TILE + j0);
          acc[g][0] += p.x * v[0].x + p.y * v[1].x + p.z * v[2].x + p.w * v[3].x;
          acc[g][1] += p.x * v[0].y + p.y * v[1].y + p.z * v[2].y + p.w * v[3].y;
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }

  // the quarters meet in the K tile; the last CTA of the kv head folds the parts
  finish_part<true>(acc, reinterpret_cast<float*>(sk), reinterpret_cast<float*>(sv), s_m, s_l,
                    s_den, &s_last, part_m, part_l, part_acc, counters,
                    out + (size_t)blockIdx.z * H * HD, nullptr, nullptr, nullptr,
                    blockIdx.z * Hkv + kvh, kvh, s_slot[0], s_slot[1], gridDim.x, G);
}

template <bool QUANT>
cudaError_t launch_raw(const CUtensorMap& k_map, const CUtensorMap& v_map,
                       const CUtensorMap& ksm_map, const CUtensorMap& vsm_map, const void* q,
                       const void* ks, const void* vs, const void* pos, const void* freqs,
                       void* part_m, void* part_l, void* part_acc, void* counters, void* out,
                       const void* vis_lanes, int B, int C, int Hkv, int G, int visible_len,
                       int split_rows, int n_splits, long long s_lane, int e1, int e_delta,
                       int extra_visible, cudaStream_t s) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_raw_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K3_SMEM);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const float qscale = LOG2E / sqrtf((float)HD);
  decode_raw_kernel<QUANT><<<dim3(n_splits + 1, Hkv, B), DEC_THREADS, K3_SMEM, s>>>(
      k_map, v_map, ksm_map, vsm_map, (const bf16*)q, (const float*)ks, (const float*)vs,
      (const float*)pos, (const float*)freqs, (float*)part_m, (float*)part_l, (float*)part_acc,
      (int*)counters, (bf16*)out, (const int*)vis_lanes, visible_len, s_lane, C, Hkv, G,
      split_rows, e1, e_delta, extra_visible, qscale);
  return cudaSuccess;
}

}  // namespace

// the largest split (rows staged at once) and the most parts (splits + the
// small block) a call of K3 may have
extern "C" int svt_decode_raw_max_split() { return TILE; }
extern "C" int svt_decode_raw_max_parts() { return MAX_PARTS; }

// K3 over B lanes, one launch. quantized != 0: kq/vq [B][C, Hkv, HD] are
// int8 with f32 scales ks/vs [B][C, Hkv]; quantized == 0: kq/vq are bf16
// and ks/vs are ignored. Lanes kq_lane / vq_lane elements apart (the
// scales s_lane), q [B, H, HD], pos [B, C, 3], small blocks [B, e1, Hkv,
// HD], out [B, H, HD]. vis_lanes: int32 [B] on the device, each <=
// max_visible (the host's largest, from which the split was chosen), or
// null: every lane sees max_visible. Scratch as K2's: part_m / part_l [B *
// Hkv, n_parts, G], part_acc [B * Hkv, n_parts, G, HD] f32 and counters [B
// * Hkv] int32 (zero between calls), n_parts = ceil(max_visible /
// split_rows) + 1.
extern "C" int svt_decode_attention_raw(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* pos, const void* freqs, const void* ksm, const void* vsm, void* part_m,
    void* part_l, void* part_acc, void* counters, void* out, const void* vis_lanes, int B, int H,
    int Hkv, int hd, int C, int e1, int e_delta, int max_visible, int extra_visible,
    int split_rows, int quantized, long long kq_lane, long long vq_lane, long long s_lane,
    void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX || Hkv > GMAX || e1 > EMAX || e1 <= e_delta ||
      C < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_splits = split_rows > 0 ? (max_visible + split_rows - 1) / split_rows : 0;
  if (split_rows < 1 || split_rows > TILE || n_splits + 1 > MAX_PARTS || max_visible < 0 ||
      max_visible > C) {
    return (int)cudaErrorInvalidValue;
  }
  // row maps over [B][rows, Hkv, HD]: boxes of CHUNK rows of one kv head of one lane
  const uint64_t bf16_row = (uint64_t)Hkv * HD * sizeof(bf16);
  const uint64_t item = quantized ? 1 : sizeof(bf16);
  CUtensorMap k_map, v_map, ksm_map, vsm_map;
  const bool ok =
      (quantized
           ? svt_tensor_map_rows(&k_map, kq, C, Hkv, HD, (uint64_t)Hkv * HD, CHUNK, true, B,
                                 kq_lane * item) &&
                 svt_tensor_map_rows(&v_map, vq, C, Hkv, HD, (uint64_t)Hkv * HD, CHUNK, true, B,
                                     vq_lane * item)
           : svt_tensor_map_rows(&k_map, kq, C, Hkv, HD * sizeof(bf16), bf16_row, CHUNK, false,
                                 B, kq_lane * item) &&
                 svt_tensor_map_rows(&v_map, vq, C, Hkv, HD * sizeof(bf16), bf16_row, CHUNK,
                                     false, B, vq_lane * item)) &&
      svt_tensor_map_rows(&ksm_map, ksm, e1, Hkv, HD * sizeof(bf16), bf16_row, CHUNK, false, B,
                          (uint64_t)e1 * bf16_row) &&
      svt_tensor_map_rows(&vsm_map, vsm, e1, Hkv, HD * sizeof(bf16), bf16_row, CHUNK, false, B,
                          (uint64_t)e1 * bf16_row);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const cudaError_t e =
      quantized ? launch_raw<true>(k_map, v_map, ksm_map, vsm_map, q, ks, vs, pos, freqs, part_m,
                                   part_l, part_acc, counters, out, vis_lanes, B, C, Hkv, G,
                                   max_visible, split_rows, n_splits, s_lane, e1, e_delta,
                                   extra_visible, s)
                : launch_raw<false>(k_map, v_map, ksm_map, vsm_map, q, ks, vs, pos, freqs,
                                    part_m, part_l, part_acc, counters, out, vis_lanes, B, C, Hkv,
                                    G, max_visible, split_rows, n_splits, s_lane, e1, e_delta,
                                    extra_visible, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
