// Multi-query verify attention over the pre-rotated arena: kernel
// K2-verify of the port, the attention of one speculative-decoding verify
// round (T = k + 1 tokens of one stream at once).
//
// It replaces no pl.pallas_call: the JAX package computes this attention in
// XLA (`_gqa_attention_multi`, streaming_vlm_tpu/models/qwen25_vl/
// language.py:106, reached from `language_forward_streaming`'s decode-delta
// path at T = k_pad). Query t (t < T) sees three parts under one joint
// softmax: arena slots < visible_len, delta rows k_small[:e_delta] below
// extra_visible, and the self rows k_small[e_delta:e_delta + t + 1] (the T
// tokens' own K/V, causal).
//
// What bounds it on an H100: bytes. A call reads every visible arena slot's
// K and V once, whatever T is (at visible 9000: 18.4 MB, 0.0056 ms at 3.35
// TB/s), against T x G query rows of tensor-core work a slot (T = 8: 56
// rows, ~1.8 GFLOP with the two P.V products below, ~2 us at the bf16
// peak). So the design reads the arena once and keeps the arithmetic per
// slot off the CUDA cores:
//   * grid (parts, kv heads), one CTA an SM: a part is one split of the
//     arena or the small block of delta + self rows. A CTA stages all its
//     rows at once, one cp.async.bulk per 256-byte row, issued by all its
//     threads (one warp issuing them all took 1.4x as long at T = 8) and
//     counted on one mbarrier per 32-row step, into rows 272 bytes apart (so
//     ldmatrix's 8 rows fall on 8 distinct groups of banks), and starts on
//     the first step while the rest fly;
//   * all T x G query rows of the kv head at once (row r = t G + g), in
//     m-tiles of 16 rows (at most 8: T <= 16, G <= 8), one a warp; where
//     the tiles are fewer than the 8 warps, the idle warps take the other
//     steps (KG = 8 / tiles key groups: warp w runs tile w % tiles over the
//     steps w / tiles, + KG, ...), so every warp works at T = 8;
//   * per 32-key step and warp: S = Q K^T by mma.sync m16n8k16 (bf16 in,
//     f32 out; Q's A fragments built once from the unscaled bf16 queries,
//     K's B fragments by ldmatrix), scaled to K2's log2 space, masked (the
//     part's rows; in the small block delta rows < extra_visible and self
//     rows e_delta .. e_delta + t), an online softmax whose row max and sum
//     are reduced over the quad that holds each row, and O += P V by
//     mma.sync with P from the S registers (the FA2 layout) and V's
//     fragments by ldmatrix.trans. P is split P_hi + P_lo, both bf16, and
//     both go through P.V: P in bf16 alone errs ~2^-9 on every weight, which
//     K2's tolerance (one bf16 ulp of each output) does not allow
//     (tests/test_torch_verify_plan.py shows both);
//   * the key groups' (m, l, O) meet in shared memory and the part's
//     partial of every query row is stored (f32, log2 space, layout [Hkv,
//     parts, T G(, HD)] in the shared decode scratch); one arrival a CTA on
//     its kv head's counter; the last to arrive folds the partials of all T
//     x G rows in one pass with all its threads (two threads a row make the
//     weights; then every thread keeps 16 predicated loads in flight, so
//     that the one SM reads the parts' rows at ~95 GB/s) and resets the
//     counter.
// The split (ops/attention.py `verify_split_size`): whole 32-key steps,
// ~sqrt(18 visible_len) rows, at least one wave of one CTA an SM, at most
// the 384-row tile. The fold reads parts x T G x 512 bytes a kv head at one
// SM's rate, a CTA its split at its share of HBM's, so the split balances
// the two; the constant is fitted to tools/profile_verify_torch.py's sweep
// (NVIDIA H100 80GB HBM3, 700 W, device ms at visible 9000 by split 288 /
// 320 / 384: T = 2 0.0177 / 0.0167 / 0.0167, T = 8 0.0297 / 0.0290 /
// 0.0288, T = 16 0.0458 / 0.0445 / 0.0437; 256 and below take a second
// wave and more parts: 0.0242 / 0.0413 / 0.0622 at 256; at 4500 the best
// were 224-256, the rule's 288 within 10%; at 640 the rule's 128).
// MAX_PARTS is what the fold's shared memory holds, far past the 25 parts
// the split gives at 9000.
// Its rows agree with K2 on each query to K2's tolerance, not bitwise: the
// tensor cores sum in another order than K2's f32 loop.

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int VT_THREADS = 256;                // 8 warps
constexpr int VT_WARPS = VT_THREADS / 32;
constexpr int STEP = 32;                       // keys a warp takes at once; one mbarrier each
constexpr int TILE = 384;                      // rows a part stages: a split or small block, at most
constexpr int NSTEP = TILE / STEP;
constexpr int ROW_BYTES = HD * 2;
constexpr int RS = ROW_BYTES + 16;             // a staged row's stride in shared memory
constexpr int TMAX = 16;                       // the most queries a call takes
constexpr int RMAX = TMAX * GMAX;              // the most query rows of a kv head
constexpr int OS = HD + 8;                     // a row's stride in the key groups' meeting buffer
constexpr size_t STAGE_BYTES = 2 * (size_t)TILE * RS;  // K, V rows
constexpr int FOLD_SLOTS = 16;                 // the fold's loads in flight a thread
constexpr size_t VERIFY_SMEM = STAGE_BYTES + sizeof(uint64_t) * NSTEP;
// the fold keeps every part's m, l and weight of each row and each row's
// denominator in the staged rows' space, then the weights, the
// denominators and its slots' sums
constexpr int MAX_PARTS = (int)((STAGE_BYTES / sizeof(float) - RMAX) / (3 * RMAX));

static_assert(4 * VT_THREADS * FOLD_SLOTS + (MAX_PARTS + 1) * RMAX <=
                  STAGE_BYTES / sizeof(float),
              "the fold's sums fit beside the weights");
static_assert(VT_THREADS * FOLD_SLOTS % (128 * (HD / 4)) == 0, "every Rp divides the slots");
static_assert(RMAX / 16 <= VT_WARPS, "an m-tile a warp");
static_assert(NSTEP <= 32, "warp 0's lanes set up the step barriers");
static_assert(VT_WARPS * 16 * (OS + 2) * sizeof(float) <= STAGE_BYTES, "the meeting buffer fits");

// bf16 pair (x, y) -> hi = round(x, y) and lo = round of what hi missed,
// each packed with x in the low half (an A fragment register)
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// *p (ld.global.cg: from L2) if `in`, else zeros; a predicated load, so
// that a loop of them issues every load before any sum waits on one
__device__ __forceinline__ float4 ldcg_if(const float4* p, bool in) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  asm("{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "l"(p), "r"((int)in));
  return v;
}

// One part (a split, or the small block) of one kv head for all T x G
// query rows -> its partial in part_* [Hkv, gridDim.x, T G(, HD)]; the last
// CTA of the kv head folds every part's into out [T, H, HD].
__global__ void __launch_bounds__(VT_THREADS, 1) verify_tc_kernel(
    const bf16* __restrict__ q,    // [T, H, HD]
    const bf16* __restrict__ ka,   // [C, Hkv, HD] pre-rotated
    const bf16* __restrict__ va,   // [C, Hkv, HD]
    const bf16* __restrict__ ksm,  // [e_delta + T, Hkv, HD] rotated delta ++ self rows
    const bf16* __restrict__ vsm,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ counters,  // [Hkv], zero between calls
    bf16* __restrict__ out,      // [T, H, HD]
    int visible_len, int Hkv, int G, int split_rows, int T, int e_delta, int extra_visible,
    float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sk = smem;            // [TILE][RS] K rows
  unsigned char* sv = sk + TILE * RS;  // [TILE][RS] V rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + STAGE_BYTES);  // one a step
  __shared__ int s_last;

  const int kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_parts = gridDim.x, part = blockIdx.x;
  const bool small = part == n_parts - 1;  // the delta + self rows
  const int H = Hkv * G, R = T * G;
  const bf16* kbase = small ? ksm : ka;
  const bf16* vbase = small ? vsm : va;
  const int row0 = small ? 0 : part * split_rows;
  const int rows = small ? e_delta + T : min(split_rows, visible_len - row0);
  const int n_steps = (rows + STEP - 1) / STEP;

  // stage every row of the part, step by step: the step barriers first,
  // then every thread issues some rows' copies
  if (warp == 0) {
    if (lane < n_steps) mbar_init(&bar[lane], 1);
    mbar_fence_init();
    __syncwarp();
    if (lane < n_steps) {
      mbar_arrive_expect_tx(&bar[lane], 2u * min(STEP, rows - lane * STEP) * ROW_BYTES);
    }
  }
  // the last step's rows past the part are zero (masked keys' weights are
  // 0, and 0 times stale bits could be NaN)
  for (int i = tid; i < (n_steps * STEP - rows) * (ROW_BYTES / 16); i += VT_THREADS) {
    const int off = (rows + i / (ROW_BYTES / 16)) * RS + 16 * (i % (ROW_BYTES / 16));
    *reinterpret_cast<uint4*>(sk + off) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(sv + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // the barriers are set up
  for (int j = tid; j < rows; j += VT_THREADS) {
    const size_t src = ((size_t)(row0 + j) * Hkv + kvh) * HD;
    bulk_load(sk + j * RS, kbase + src, ROW_BYTES, &bar[j / STEP]);
    bulk_load(sv + j * RS, vbase + src, ROW_BYTES, &bar[j / STEP]);
  }

  // warp w: m-tile w % n_mt over the steps w / n_mt, + KG, ...
  const int n_mt = (R + 15) / 16, KG = VT_WARPS / n_mt;
  const int mt = warp % n_mt, kg = warp / n_mt;
  const bool active = kg < KG;
  const int g4 = lane / 4, t4 = lane % 4;  // the lane's rows 16 mt + g4 (+8), its columns 2 t4 (+1)
  float o[HD / 8][4];  // O: dims 8 nd + 2 t4 (+1) of the two rows
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  if (active) {
    // Q's A fragments, one per 16 head dims (pad rows r >= R are zero)
    uint32_t qa[HD / 16][4];
    int tq[2];  // the rows' queries
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g4 + 8 * h;
      tq[h] = r / G;
      const bf16* qrow = q + ((size_t)(r / G) * H + (size_t)kvh * G + r % G) * HD + 2 * t4;
      const unsigned int* qw = reinterpret_cast<const unsigned int*>(qrow);  // bf16 pairs
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][h] = r < R ? __ldg(qw + 8 * kk) : 0u;
        qa[kk][2 + h] = r < R ? __ldg(qw + 8 * kk + 4) : 0u;
      }
    }
    // ldmatrix rows of this lane: K (keys + (lane / 16) 8 + lane % 8, dims
    // + (lane / 8 % 2) 8); V transposed (keys + (lane / 8 % 2) 8 + lane % 8,
    // dims + (lane / 16) 8)
    const unsigned char* krow = sk + ((lane / 16) * 8 + lane % 8) * RS + (lane / 8 % 2) * 16;
    const unsigned char* vrow = sv + ((lane / 8 % 2) * 8 + lane % 8) * RS + (lane / 16) * 16;

    for (int b = kg; b < n_steps; b += KG) {
      mbar_wait(&bar[b], 0);
      const int j0 = b * STEP;
      // S = Q K^T over the step's 32 keys: 4 blocks of 8 keys
      float s[STEP / 8][4];
#pragma unroll
      for (int nb = 0; nb < STEP / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int kb = 0; kb < STEP / 16; ++kb) {
          uint32_t f[4];
          ldmatrix_x4(f, krow + (j0 + 16 * kb) * RS + 32 * kk);
          mma_m16n8k16_bf16(s[2 * kb], qa[kk], f[0], f[1]);
          mma_m16n8k16_bf16(s[2 * kb + 1], qa[kk], f[2], f[3]);
        }
      }
      // log2-space logits; the keys this row does not see are -inf
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < STEP / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * nb + 2 * t4 + (e & 1);
          bool vis = j < rows;
          if (small) vis = vis && (j < extra_visible || (j >= e_delta && j <= e_delta + tq[e / 2]));
          s[nb][e] = vis ? s[nb][e] * qscale : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[nb][e]);
        }
      }
      // the online softmax: row maxima over the quad, O and l rescaled
      float base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        base[h] = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: subtract 0
        const float alpha = m_r[h] == -INFINITY ? 0.f : exp2f(m_r[h] - base[h]);
        m_r[h] = m_new;
        l_r[h] *= alpha;
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          o[nd][2 * h] *= alpha;
          o[nd][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nb = 0; nb < STEP / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = exp2f(s[nb][e] - base[e / 2]);
          l_r[e / 2] += s[nb][e];
        }
      }
      // O += P V over each 16 keys: P_hi and P_lo (A fragments from the S
      // registers), V's B fragments for 16 head dims a ldmatrix.trans
#pragma unroll
      for (int ks = 0; ks < STEP / 16; ++ks) {
        uint32_t ph[4], pl[4];
        split_bf16x2(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
        split_bf16x2(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
        split_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
        split_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int nd2 = 0; nd2 < HD / 16; ++nd2) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, vrow + (j0 + 16 * ks) * RS + 32 * nd2);
          mma_m16n8k16_bf16(o[2 * nd2], ph, f[0], f[1]);
          mma_m16n8k16_bf16(o[2 * nd2], pl, f[0], f[1]);
          mma_m16n8k16_bf16(o[2 * nd2 + 1], ph, f[2], f[3]);
          mma_m16n8k16_bf16(o[2 * nd2 + 1], pl, f[2], f[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    }
  }
  __syncthreads();  // every step is read (each was waited on by its warps): the rows' space is free

  // the key groups meet: each warp's (m, l, O) of its 16 rows
  float* mo = reinterpret_cast<float*>(smem);  // [VT_WARPS][16][OS]
  float* mm = mo + VT_WARPS * 16 * OS;         // [VT_WARPS][16]
  float* ml = mm + VT_WARPS * 16;
  if (active) {
    float* base_w = mo + warp * 16 * OS + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      *reinterpret_cast<float2*>(base_w + g4 * OS + 8 * nd) = make_float2(o[nd][0], o[nd][1]);
      *reinterpret_cast<float2*>(base_w + (g4 + 8) * OS + 8 * nd) = make_float2(o[nd][2], o[nd][3]);
    }
    if (t4 == 0) {
      mm[warp * 16 + g4] = m_r[0];
      mm[warp * 16 + g4 + 8] = m_r[1];
      ml[warp * 16 + g4] = l_r[0];
      ml[warp * 16 + g4 + 8] = l_r[1];
    }
  }
  __syncthreads();
  // the part's partial of each query row: its key groups merged
  const size_t head_rows = (size_t)kvh * n_parts * R;  // this kv head's first partial row
  const size_t prow = head_rows + (size_t)part * R;
  for (int i = tid; i < R * (HD / 4); i += VT_THREADS) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4));
    const int w0 = r / 16, rr = r % 16;  // the warps of the row's m-tile: w0 + n_mt k
    float mx = -INFINITY;
    for (int k = 0; k < KG; ++k) mx = fmaxf(mx, mm[(w0 + n_mt * k) * 16 + rr]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int k = 0; k < KG; ++k) {
      const int w = w0 + n_mt * k;
      const float m = mm[w * 16 + rr];
      const float wt = m == -INFINITY ? 0.f : exp2f(m - mx);
      const float4 x = *reinterpret_cast<const float4*>(mo + (w * 16 + rr) * OS + d);
      a.x += wt * x.x;
      a.y += wt * x.y;
      a.z += wt * x.z;
      a.w += wt * x.w;
      l += wt * ml[w * 16 + rr];
    }
    *reinterpret_cast<float4*>(part_acc + (prow + r) * HD + d) = a;
    if (d == 0) {
      part_m[prow + r] = mx;
      part_l[prow + r] = l;
    }
  }

  // one arrival a CTA; the last of the kv head folds all T x G rows
  if (!arrive_last(counters, kvh, n_parts, &s_last)) return;
  // shared memory: (m, l) of every part and row from the start, each row's
  // weights and denominator at the end
  float* sw = reinterpret_cast<float*>(smem + STAGE_BYTES) - (n_parts + 1) * R;  // [n_parts][R]
  float* sden = sw + n_parts * R;                                                  // [R]
  float* sm = reinterpret_cast<float*>(smem);  // [n_parts][R]
  float* sl = sm + n_parts * R;                // [n_parts][R]
#pragma unroll 4
  for (int i = tid; i < n_parts * R; i += VT_THREADS) {
    sm[i] = __ldcg(part_m + head_rows + i);
    sl[i] = __ldcg(part_l + head_rows + i);
  }
  __syncthreads();
  {  // row r's maximum, weights and denominator: threads 2 r and 2 r + 1, every other part each
    const int r = tid / 2, h = tid % 2;
    const float *mr = sm + r, *lr = sl + r;  // row r's (m, l) in each part
    float mx = -INFINITY;
#pragma unroll 4
    for (int p = h; r < R && p < n_parts; p += 2) mx = fmaxf(mx, mr[p * R]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float den = 0.f;
#pragma unroll 4
    for (int p = h; r < R && p < n_parts; p += 2) {
      const float m = mr[p * R];
      const float wt = m == -INFINITY ? 0.f : exp2f(m - mx);
      sw[p * R + r] = wt;
      den += wt * lr[p * R];
    }
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    if (r < R && h == 0) sden[r] = den;
  }
  __syncthreads();  // the weights are made; (m, l)'s space takes the sums
  // Each row's weighted sum of the parts' partial rows, FOLD_SLOTS loads
  // in flight a thread: item i = row i / 32, dims 4 (i % 32), of Rp rows
  // (R to a power of two); slot k of thread tid is pair j = tid +
  // VT_THREADS k: item j % (32 Rp) of the parts j / (32 Rp) + pps n, with
  // pps = VT_THREADS FOLD_SLOTS / (32 Rp) parts in flight at once. A slot
  // keeps its float4's offset in part 0's place (a row past R: never
  // read); its weight's offset is that over 32.
  const int Rp = R <= 16 ? 16 : R <= 32 ? 32 : R <= 64 ? 64 : 128;
  const int items = Rp * (HD / 4), pps = VT_THREADS * FOLD_SLOTS / items;
  const int shift = 31 - __clz(items);
  const float4* src = reinterpret_cast<const float4*>(part_acc + head_rows * HD);
  const int end = n_parts * R * (HD / 4);  // past the last part's float4s
  int off[FOLD_SLOTS];
  float4 a[FOLD_SLOTS];
#pragma unroll
  for (int k = 0; k < FOLD_SLOTS; ++k) {
    const int j = tid + VT_THREADS * k, i = j & (items - 1), r = i / (HD / 4);
    off[k] = r < R ? ((j >> shift) * R + r) * (HD / 4) + i % (HD / 4) : end;
    a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 1
  for (int base = 0; base < end; base += pps * R * (HD / 4)) {
#pragma unroll
    for (int k = 0; k < FOLD_SLOTS; ++k) {  // no branch: every slot's load is in flight at once
      const int o = off[k] + base;
      const bool in = o < end;
      const float4 x = ldcg_if(src + o, in);
      const float wt = in ? sw[min(o, end - 1) / (HD / 4)] : 0.f;
      a[k].x += wt * x.x;
      a[k].y += wt * x.y;
      a[k].z += wt * x.z;
      a[k].w += wt * x.w;
    }
  }
  float4* red = reinterpret_cast<float4*>(smem);  // [VT_THREADS FOLD_SLOTS] the slots' sums
#pragma unroll
  for (int k = 0; k < FOLD_SLOTS; ++k) red[tid + VT_THREADS * k] = a[k];
  __syncthreads();
  // the output rows: each item's pps slots added, divided by the row's denominator
#pragma unroll 4
  for (int i = tid; i < R * (HD / 4); i += VT_THREADS) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4));
    float4 x = red[i];
    for (int ph = 1; ph < pps; ++ph) {
      const float4 y = red[ph * items + i];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    const float inv = 1.f / fmaxf(sden[r], 1e-20f);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * inv, x.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * inv, x.w * inv);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + ((size_t)(r / G) * H + (size_t)kvh * G + r % G) * HD + d) = pk;
  }
  if (tid == 0) counters[kvh] = 0;  // ready for the next call
}

}  // namespace

// the largest split, the most parts (splits + the small block), the most
// queries, and the most small-block rows (e_delta + T) a call may have
extern "C" int svt_verify_max_split() { return TILE; }
extern "C" int svt_verify_max_parts() { return MAX_PARTS; }
extern "C" int svt_verify_max_queries() { return TMAX; }
extern "C" int svt_verify_max_small_rows() { return TILE; }

// K2-verify: q [T, H, HD], arenas [C, Hkv, HD], small block [e_delta + T,
// Hkv, HD], out [T, H, HD]. Scratch: part_m / part_l [Hkv, n_parts, T G],
// part_acc [Hkv, n_parts, T G, HD] f32 (the decode scratch's rows of T
// heads) and counters [Hkv] int32 (zero between calls), n_parts =
// ceil(visible_len / split_rows) + 1.
extern "C" int svt_verify_attention(
    const void* q, const void* ka, const void* va, const void* ksm, const void* vsm,
    void* part_m, void* part_l, void* part_acc, void* counters, void* out, int T, int H, int Hkv,
    int hd, int e_delta, int visible_len, int extra_visible, int split_rows, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX || T < 1 || T > TMAX || e_delta < 0 ||
      e_delta + T > TILE || extra_visible < 0 || extra_visible > e_delta || visible_len < 0 ||
      split_rows < 1 || split_rows > TILE) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_splits = (visible_len + split_rows - 1) / split_rows;
  if (n_splits + 1 > MAX_PARTS) return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        verify_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)VERIFY_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const dim3 grid(n_splits + 1, Hkv);
  verify_tc_kernel<<<grid, VT_THREADS, VERIFY_SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const bf16*)q, (const bf16*)ka, (const bf16*)va, (const bf16*)ksm, (const bf16*)vsm,
      (float*)part_m, (float*)part_l, (float*)part_acc, (int*)counters, (bf16*)out, visible_len,
      Hkv, H / Hkv, split_rows, T, e_delta, extra_visible, LOG2E / sqrtf((float)HD));
  return (int)cudaGetLastError();
}
