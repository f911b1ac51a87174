// Single-token decode attention over the pre-rotated arena: kernel K2 of
// the port (arena + decode delta + self under one joint softmax) and kernel
// K4 (the arena's log2-space partials alone).
//
// K2 replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_decode_attention_full` / `_decode_full_kernel`. Three parts
// share one softmax: arena slots < visible_len, delta rows
// k_small[:e_delta] below extra_visible, and the always-visible self rows
// k_small[e_delta:].
//
// K4 replaces `streaming_decode_attention` / `_decode_kernel`, the JAX
// package's test-only cross-check of K2: the same split pass, then a
// combine that returns the merged unnormalised partials (m [H], l [H], acc
// [H, HD], log2 space) instead of dividing. At visible_len == 0 it returns
// m = -1e30, l = 0, acc = 0, as the TPU kernel does.
//
// What bounds them on an H100: bytes. One token reads every visible arena
// slot's K and V once (at visible 9000: 18.4 MB, 5.5 us at 3.35 TB/s),
// against ~0.13 GFLOP of f32 math. The design keeps those bytes in flight
// and the chains short (split-K flash decoding in one launch):
//   * grid (parts, kv heads, lanes): a part is one split of `split`
//     consecutive visible slots (the host picks `split` from the lanes'
//     largest visible_len so that the grid fills the card: ops/attention.py
//     `decode_split_size`), or, for K2, the small block of delta + self
//     rows, which runs beside the arena splits as one more partial. K2's
//     lane form serves B streams in one launch: lane b reads its own arena
//     (lane-strided), queries, small block and visible length (an int32
//     device array, so the host never waits for it), and a split past its
//     length exits before it touches memory;
//   * a CTA stages its rows' K and V (256 bytes each) into shared memory
//     with one cp.async.bulk per row, all started at once by one warp and
//     counted on four mbarriers, one per quarter of the rows, so that Q.K
//     starts on the first rows while the rest are in flight: up to 2 x 80 KB
//     in flight per SM;
//   * Q.K from shared memory: a warp takes 4 rows at a time; lane l owns
//     head dims [4l, 4l + 4) of each (conflict-free 8-byte reads) and of
//     the G = H / Hkv queries, held in registers, and one transposing
//     butterfly (31 shuffles) finishes all 32 (row, query head) sums of the
//     4 rows at once; the softmax of each query head is one warp's; P.V:
//     thread t owns head dims 2 (t % 64) + {0, 1} of every 4th group of 4
//     rows (t / 64 picks which), and the four quarters meet in shared
//     memory;
//   * the combine is fused: each CTA writes its partial (m, l, acc) and
//     counts itself in on its kv head's counter; the last to arrive reads
//     every part's (m, l) into shared memory in one coalesced pass, folds
//     the partial rows in parallel (each quarter of the threads a strided
//     subset of the parts, four parts' loads in flight) and writes the
//     output (K2: divided; K4: the merged partials), then resets the
//     counter for the next call.
// q is scaled in f32 (softmax-scale * log2(e)); every sum is f32.

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 160;                     // rows staged at once: the largest split
constexpr int ROW_BYTES = HD * 2;             // one bf16 K or V row of one kv head
constexpr int CHUNKS = 4;                     // a tile arrives in chunks of TILE / CHUNKS rows,
constexpr int CHUNK = TILE / CHUNKS;          // one mbarrier each
constexpr size_t K2_SMEM = 2 * (size_t)TILE * ROW_BYTES           // K, V tiles
                           + sizeof(float) * GMAX * HD              // scaled q
                           + sizeof(float) * GMAX * TILE            // logits, then weights
                           + sizeof(float) * 4 * GMAX               // m, l, alpha, den
                           + sizeof(uint64_t) * CHUNKS;             // mbarriers
// the fused combine keeps one weight per (query head, part) in the K tile
constexpr int MAX_PARTS = TILE * ROW_BYTES / (GMAX * (int)sizeof(float));

static_assert(CHUNK % 4 == 0, "a warp's group of 4 rows lies in one chunk");
// a part is at most two tiles (the small block's EMAX rows), so each chunk's
// barrier completes once per tile it is waited on in
static_assert(EMAX <= 2 * TILE, "the small block must fit in two tiles");
static_assert(QUARTERS * GMAX * HD * sizeof(float) <= TILE * ROW_BYTES, "reduction fits in a tile");

// One split (or K2's small block) of one kv head of one lane -> its partial
// (m, l, acc) in part_* [B * Hkv, gridDim.x, G(, HD)]; the last CTA of the
// (lane, kv head) to finish folds the lane's n_parts partials into the
// output (FULL: K2's normalised bf16 row per query head; else K4's merged
// partials, one lane).
template <bool FULL>
__global__ void __launch_bounds__(DEC_THREADS, 2) decode_split_kernel(
    const bf16* __restrict__ q,      // [B, H, HD]
    const bf16* __restrict__ ka,     // [B, C, Hkv, HD] pre-rotated, lanes ka_lane apart
    const bf16* __restrict__ va,     // [B, C, Hkv, HD], lanes va_lane apart
    const bf16* __restrict__ ksm,    // [B, E1, Hkv, HD] rotated delta ++ self rows (FULL)
    const bf16* __restrict__ vsm,    // [B, E1, Hkv, HD]
    float* __restrict__ part_m,      // [B * Hkv, gridDim.x, G]
    float* __restrict__ part_l,      // [B * Hkv, gridDim.x, G]
    float* __restrict__ part_acc,    // [B * Hkv, gridDim.x, G, HD]
    int* __restrict__ counters,      // [B * Hkv], zero between calls
    bf16* __restrict__ out,          // [B, H, HD] (FULL)
    float* __restrict__ m_out,       // [H] (K4)
    float* __restrict__ l_out,       // [H] (K4)
    float* __restrict__ acc_out,     // [H, HD] (K4)
    const int* __restrict__ vis_lanes,  // [B] visible lengths, or null: vis_host for all
    int vis_host, long long ka_lane, long long va_lane,  // arena lane strides (elements)
    int Hkv, int G, int split_rows, int e1, int e_delta, int extra_visible, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sk = smem;                                      // [TILE][HD] bf16
  unsigned char* sv = sk + TILE * ROW_BYTES;                     // [TILE][HD] bf16
  float* sq = reinterpret_cast<float*>(sv + TILE * ROW_BYTES);  // [GMAX][HD]
  float* sp = sq + GMAX * HD;                                    // [GMAX][TILE]
  float* s_m = sp + GMAX * TILE;                                 // running max per query head
  float* s_l = s_m + GMAX;
  float* s_alpha = s_l + GMAX;
  float* s_den = s_alpha + GMAX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_den + GMAX);
  __shared__ int s_last;

  const int kvh = blockIdx.y, b = blockIdx.z;  // kv head, lane
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this lane's splits; the grid holds the lanes' largest count (+ K2's
  // small block, its last part)
  const int max_splits = gridDim.x - (FULL ? 1 : 0);
  const int visible_len = lane_visible(vis_lanes, vis_host, b, max_splits * split_rows);
  const int n_splits = (visible_len + split_rows - 1) / split_rows;
  const bool small = FULL && blockIdx.x == gridDim.x - 1;  // K2's delta + self rows
  if (!small && (int)blockIdx.x >= n_splits) return;  // past this lane's visible slots
  const int part = small ? n_splits : blockIdx.x;      // the partial's slot
  // the slot and the lane's part count wait in shared memory for finish_part
  __shared__ int s_slot[2];
  if (threadIdx.x == 0) {
    s_slot[0] = part;
    s_slot[1] = n_splits + (FULL ? 1 : 0);
  }
  const size_t H = (size_t)Hkv * G;
  q += b * H * HD;
  ka += b * ka_lane;
  va += b * va_lane;
  if (FULL) {
    ksm += (size_t)b * e1 * Hkv * HD;
    vsm += (size_t)b * e1 * Hkv * HD;
  }

  // the rows of this part: arena slots [row0, row0 + rows), or k_small [0, e1)
  const bf16* kbase = small ? ksm : ka;
  const bf16* vbase = small ? vsm : va;
  const int row0 = small ? 0 : part * split_rows;
  const int rows = small ? e1 : min(split_rows, visible_len - row0);

  // stage the first tile's K and V rows (256 bytes each) with bulk copies,
  // then the queries while they fly
  auto stage_tile = [&](int t0, int n) {
    if (warp == 0) {
      if (lane < CHUNKS && lane * CHUNK < n) {
        mbar_arrive_expect_tx(&bar[lane], 2u * min(CHUNK, n - lane * CHUNK) * ROW_BYTES);
      }
      __syncwarp();
      for (int j = lane; j < n; j += 32) {
        const size_t src = ((size_t)(row0 + t0 + j) * Hkv + kvh) * HD;
        bulk_load(sk + j * ROW_BYTES, kbase + src, ROW_BYTES, &bar[j / CHUNK]);
        bulk_load(sv + j * ROW_BYTES, vbase + src, ROW_BYTES, &bar[j / CHUNK]);
      }
    }
  };
  if (warp == 0) {
    if (lane < CHUNKS) {
      mbar_init(&bar[lane], 1);
      mbar_fence_init();
    }
    __syncwarp();
    if (rows > 0) stage_tile(0, min(TILE, rows));
  }
  for (int i = tid; i < GMAX * HD; i += DEC_THREADS) {
    sq[i] = i < G * HD ? __bfloat162float(q[(size_t)kvh * G * HD + i]) * qscale : 0.f;
  }
  if (tid < GMAX) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  float qr[GMAX][4];  // this lane's head dims [4 lane, 4 lane + 4) of every query head
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(sq + g * HD + 4 * lane);
    qr[g][0] = v.x;
    qr[g][1] = v.y;
    qr[g][2] = v.z;
    qr[g][3] = v.w;
  }
  float acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int dp = tid % (HD / 2), quarter = tid / (HD / 2);

  uint32_t parity = 0;
  for (int t0 = 0; t0 < rows; t0 += TILE) {
    const int n = min(TILE, rows - t0);
    const int n4 = (n + 3) / 4 * 4;
    if (t0 > 0) stage_tile(t0, n);

    // logits: warp w takes the groups of 4 rows starting at 4 (w + 8 i). A
    // lane sums its 4 head dims for the 32 (row, query head) pairs of the
    // group, and a transposing butterfly (31 shuffles) leaves the whole
    // sum of pair `lane` (row lane / 8, query head lane % 8) in lane `lane`
    for (int j0 = 4 * warp; j0 < n; j0 += 4 * DEC_WARPS) {
      // the warp's first rows in a chunk (a new chunk starts within its stride)
      if (j0 % CHUNK < 4 * DEC_WARPS) mbar_wait(&bar[j0 / CHUNK], parity);
      float v[32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 u = *reinterpret_cast<const uint2*>(sk + (j0 + r) * ROW_BYTES + 8 * lane);
        const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          v[r * GMAX + g] =
              qr[g][0] * k01.x + qr[g][1] * k01.y + qr[g][2] * k23.x + qr[g][3] * k23.y;
        }
      }
      butterfly<16>(v, lane);
      butterfly<8>(v, lane);
      butterfly<4>(v, lane);
      butterfly<2>(v, lane);
      butterfly<1>(v, lane);
      const int g = lane % GMAX, j = j0 + lane / GMAX;
      const int jj = t0 + j;  // row within the part
      const bool vis = j < n && (!small || jj < extra_visible || jj >= e_delta);
      if (g < G) sp[g * TILE + j] = vis ? v[0] : -INFINITY;
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
    // 4 (quarter + 4 i)
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
        v[r] = j0 + r < n ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                sv + (j0 + r) * ROW_BYTES + 4 * dp))
                          : make_float2(0.f, 0.f);
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
  finish_part<FULL>(acc, reinterpret_cast<float*>(sk), reinterpret_cast<float*>(sv), s_m, s_l,
                    s_den, &s_last, part_m, part_l, part_acc, counters,
                    FULL ? out + (size_t)blockIdx.z * H * HD : out, m_out, l_out,
                    acc_out, blockIdx.z * Hkv + kvh, kvh, s_slot[0], s_slot[1], gridDim.x, G);
}

__global__ void decode_partials_empty_kernel(float* m_out, float* l_out, float* acc_out,
                                             int H) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < H * HD;
       i += gridDim.x * blockDim.x) {
    acc_out[i] = 0.f;
    if (i < H) {
      m_out[i] = -1e30f;
      l_out[i] = 0.f;
    }
  }
}

template <bool FULL>
cudaError_t launch_split(const void* q, const void* ka, const void* va, const void* ksm,
                         const void* vsm, void* part_m, void* part_l, void* part_acc,
                         void* counters, void* out, void* m_out, void* l_out, void* acc_out,
                         const void* vis_lanes, int B, int Hkv, int G, int visible_len,
                         int split_rows, int n_splits, long long ka_lane, long long va_lane,
                         int e1, int e_delta, int extra_visible, cudaStream_t s) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K2_SMEM);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const float qscale = LOG2E / sqrtf((float)HD);
  const dim3 grid(n_splits + (FULL ? 1 : 0), Hkv, B);
  decode_split_kernel<FULL><<<grid, DEC_THREADS, K2_SMEM, s>>>(
      (const bf16*)q, (const bf16*)ka, (const bf16*)va, (const bf16*)ksm, (const bf16*)vsm,
      (float*)part_m, (float*)part_l, (float*)part_acc, (int*)counters, (bf16*)out,
      (float*)m_out, (float*)l_out, (float*)acc_out, (const int*)vis_lanes, visible_len, ka_lane,
      va_lane, Hkv, G, split_rows, e1, e_delta, extra_visible, qscale);
  return cudaSuccess;
}

bool bad_split(int visible_len, int split_rows, int n_parts) {
  return split_rows < 1 || split_rows > TILE || n_parts > MAX_PARTS || visible_len < 0;
}

}  // namespace

// the largest split (rows staged at once) and the most parts (splits + the
// small block) a call of K2 or K4 may have
extern "C" int svt_decode_max_split() { return TILE; }
extern "C" int svt_decode_max_parts() { return MAX_PARTS; }

extern "C" int svt_decode_max_small_rows() { return EMAX; }

// K2 over B lanes: q [B, H, HD], arenas [B, C, Hkv, HD] with lanes
// ka_lane / va_lane elements apart, small blocks [B, e1, Hkv, HD], out [B,
// H, HD]. vis_lanes: int32 [B] on the device, each <= max_visible (the
// host's largest, from which the split was chosen), or null: every lane
// sees max_visible. Scratch: part_m / part_l [B * Hkv, n_parts, G],
// part_acc [B * Hkv, n_parts, G, HD] f32 and counters [B * Hkv] int32
// (zero between calls), n_parts = ceil(max_visible / split_rows) + 1.
extern "C" int svt_decode_attention(
    const void* q, const void* ka, const void* va, const void* ksm, const void* vsm,
    void* part_m, void* part_l, void* part_acc, void* counters, void* out,
    const void* vis_lanes, int B, int H, int Hkv, int hd, int e1, int e_delta, int max_visible,
    int extra_visible, int split_rows, long long ka_lane, long long va_lane, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX || e1 > EMAX || e1 <= e_delta || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_splits = split_rows > 0 ? (max_visible + split_rows - 1) / split_rows : 0;
  if (bad_split(max_visible, split_rows, n_splits + 1)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_split<true>(
      q, ka, va, ksm, vsm, part_m, part_l, part_acc, counters, out, nullptr, nullptr, nullptr,
      vis_lanes, B, Hkv, H / Hkv, max_visible, split_rows, n_splits, ka_lane, va_lane, e1,
      e_delta, extra_visible, reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K4: merged log2-space partials of one token over arena slots <
// visible_len. Scratch as K2's, with n_parts = ceil(visible_len /
// split_rows) (no small block).
extern "C" int svt_decode_partials(
    const void* q, const void* ka, const void* va, void* part_m, void* part_l, void* part_acc,
    void* counters, void* m_out, void* l_out, void* acc_out, int H, int Hkv, int hd,
    int visible_len, int split_rows, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_splits = split_rows > 0 ? (visible_len + split_rows - 1) / split_rows : 0;
  if (bad_split(visible_len, split_rows, n_splits)) return (int)cudaErrorInvalidValue;
  if (n_splits == 0) {
    decode_partials_empty_kernel<<<(H * HD + 127) / 128, 128, 0, s>>>(
        (float*)m_out, (float*)l_out, (float*)acc_out, H);
    return (int)cudaGetLastError();
  }
  const cudaError_t e = launch_split<false>(
      q, ka, va, nullptr, nullptr, part_m, part_l, part_acc, counters, nullptr, m_out, l_out,
      acc_out, nullptr, 1, Hkv, H / Hkv, visible_len, split_rows, n_splits, 0, 0, 0, 0, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
