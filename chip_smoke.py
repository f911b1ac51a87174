#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # the full run (one card)

Phases; any failure exits non-zero:

1. device: requires CUDA; prints `nvidia-smi` name and power limit.
2. build: compiles the port's kernels (streaming_vlm_tpu_torch/csrc, nvcc,
   sm_90a, one nvcc per source in parallel) into build/torch_kernels/, and
   prints -Xptxas -v registers and spills of K1-K5's, K2-verify's, K1-bwd's
   (both modes) and CE-row's kernels, and the CTAs a cluster of K1-bwd's
   full-block kernel and how many such clusters the card holds at once.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (Qwen2.5-VL-7B attention geometry: H=28, Hkv=4,
   hd=128, arena C=10240): K1 prefill (both arena modes; T in {640, 200,
   64}, visible lengths on and off its 128-key tile; and recompute mode's
   causal self block alone at T = 10240, visible 0), K2 decode over the
   pre-rotated arena (visible 0 to C, on and off the host's split, a small
   block longer than the kernel's tile), K3 decode over the raw arena (int8
   and bf16 storage, shrink- and append-range positions, visible 0 to C on
   and off the host's split, a small block longer than the kernel's tile;
   one kernel a call), K4 decode
   partials (and their merge with the small block against K2), K2-verify
   (spec decode's verify attention: T in {1, 2, 3, 8, 9, 16} queries, the
   m-tile edges, visible 0 to C - e_delta - T on and off the host's split,
   extra_visible 0 to e_delta; each of its rows also against K2 on that
   query with the small block cut to the rows it sees, to K2's tolerance
   (bitwise at T = 1, where the wrapper is K2); timed at T = 8, visible
   9000 beside K2 called 8 times, and at T = 2 and 16), K5 W8A8
   products (the int32 form at the TPU probe's 4096^3 and at ragged shapes;
   the serving form at every (M, K, N) of the 7B path, Qwen2-VL's vision
   products included, bf16 and f32 out, weights in QLinear's padded rows),
   K5-int4 W4A8 products (qdot4 below 32 rows: every decode product of the
   7B path and the lm_head at M in {1, 4, 8, 31}, bf16 and f32 out, one
   scale group and many, under the planner's plan and with K cut into
   slabs by force), training's kernels: K1's log-sum-exp output (rows the
   plan keeps whole and rows it splits, both arena modes; K1's output
   unchanged by asking for it; timed at T = 8192 with and without it),
   K1-bwd (dQ, dK, dV against the plain algebra in f32 at T in {64, 200,
   640, 2048, 8192}, two bf16 ulps of each value plus two of the largest;
   two calls bitwise equal; timed at T = 8192 beside K1's forward, SDPA's
   causal forward + backward and the bound), and CE-row (NLL to 1e-5
   relative, dlog to 1e-6 absolute, at V = 152064 and rows {1, 77, 2048},
   masked rows, targets 0 and V - 1; timed at [2048, V] beside its byte
   bound and F.cross_entropy's forward + backward). K1 and the decode kernels are held to
   one bf16 ulp of each output value (plus one ulp of the largest for K1, a
   small fraction of it for the others), K5 and K5-int4 to bitwise
   equality, and phase 3 is run again on copies of the port with K1
   (kernel or plan), K2, K3, K5 (kernel or plan) or K5-int4 broken on
   purpose (MUTANTS): each copy must fail, on
   the broken kernel's checks only. K1's plan must reach the card without a
   host sync. The lane forms (B streams in one launch, per-lane lengths:
   K2 and K3 at B in {1, 4, 8} with lanes shorter than one split and empty
   ones, both storage forms of K3, K1 at 6 ragged lanes in both modes) are
   held to the same tolerances against their plain lane versions, and
   their own mutants must fail their lane checks alone. Times from CUDA events and profiler device time, beside each
   kernel's bound and, where one PyTorch call computes the same function,
   that call's time (K5's int32 form at every tiled shape beside
   torch._int_mm; K2's and K3's device time at visible 640, 4500 and
   9000; K5-int4 at every decode product and M in {1, 4, 8} and K5's
   decode GEMV also with cold weights: each call rotates over copies of its
   weight past twice the 50 MB L2, as a decode step finds them). K3's bound
   counts the f32 work that its dtype chain keeps off the tensor cores at
   the f32 rate beside its bytes. K1 is also held at the evaluation
   harnesses' shapes (`_phase_k1_eval`): the batched MCQ forward's 8
   right-padded lanes of T = 1024 at visible 0, VQA's raw-mode prefill of
   T = 1024 over a fresh 2048-slot arena at visible 0 and its raw-mode
   T = 1 steps at visible 700-1000, with device times beside SDPA's.
4. reference: at 7B width (decoder cut to 4 layers), the streaming forward
   through the kernels (chunk prefill, then one decode token) in bf16
   against the plain full-attention oracle `language_forward` in f32 on the
   same random weights: over the pre-rotated bf16 arena (K1, K2), over the
   int8 raw arena (K1 raw mode, K3), and with W8A8 weights over the int8
   pre-rotated arena (K5, K1, K2; the oracle runs the dequantized weights);
   with W4A8 weights over the same arena (the prefill's products through
   qdot4's bf16 product, the decode step's through K5-int4; the oracle runs
   the dequantized int4 weights), the same at Qwen2-VL-7B's widths (bf16
   and W8A8), and Qwen2-VL-7B's
   vision tower (4 of its blocks, one chunk's frames patchified on the card)
   in bf16 and W8A8 (K5) against its f32 oracle. Then a spec-decode verify
   forward of 8 tokens after the prefill (K2-verify; over the pre-rotated
   bf16 arena, and with W8A8 weights over the int8 arena) against the f32
   oracle on the same tokens, and r, the largest logit difference between
   its rows and K2 decode steps over the same tokens (over max |logit|).
   Then the batched MCQ forward (`eval.mcq`, 4 right-padded questions, two
   with a vision crop; K1 once a layer) against `forward_full` in f32, each
   question's option logits, under the same noise rule.
   Then training: `sft_loss` at 7B widths (decoder cut to 4 layers, T =
   2048, vision embeddings scattered in) and its text gradients through the
   kernels in bf16 (K1 with its log-sum-exp, K1-bwd, CE-row) against the
   same loss through the plain path in f32: the loss's relative error <=
   2e-2 and each leaf's relative L2 error <= 5e-2, or each within 2x the
   plain path's own error in bf16 (the noise floor).
5. slices: Qwen2.5-VL-7B served through `serve.streaming_inference_frames`,
   18 one-second chunks of 2 synthetic 476x840 frames each, three times:
   slice A with random bf16 weights and the default StreamConfig (the
   pre-rotated bf16 arena: K1 + K2), slice B with the same weights and
   StreamConfig(kv_quant="int8", prerotate_arena=False) (the int8 raw
   arena: K1 raw mode + K3), and slice C with random W8A8 weights
   (`random_quantized_model`) and StreamConfig(kv_quant="int8") (the int8
   arena, pre-rotated: K5 + K1 + K2). Each asserts an eviction, kv <=
   kv_capacity, and from launch counts reset just before it that every
   kernel call of its run went through the kernels, as many times as the
   path makes them (K5's by path: decode GEMV and tiled). Then three
   multi-stream slices, bench.py's multi-stream setup through
   MultiStreamEngine on the W8A8 weights (warm round + reset_lane, 18
   rounds, the last lane idle in rounds 3 and 11, each lane its own frames
   and query): slice D, 6 lanes over the int8 pre-rotated arena (K1 and K2
   lane forms, K5 tiled at M = 6); slice E, 8 lanes with rot_quant="int8";
   slice F, 4 lanes over the int8 raw arena (K1 raw and K3 lane forms).
   Each prints round wall p50 / max, aggregate ingest frames/s and the
   lanes' occupancy after eviction, and checks its launch counts. Slice G
   serves Qwen2-VL-7B (random W8A8 weights, all 28 layers and 32 vision
   blocks, kv_quant="int8") through bench.py's single-stream route:
   `prewarm`, a throwaway warm chunk, a fresh `StreamingSession`, 18 chunks
   whose frames are uploaded and patchified on the card, the next chunk's
   encode launched behind each step, and bench.py's qa question at chunk
   10 (a larger bucket); it prints p50, max and the qa chunk. Slice H
   serves slice A's bf16 weights in recompute mode (efficiency config (c):
   window 16, text rounds 16, no sink, kv_capacity 14848, buckets to
   10240): every chunk re-encodes its window and re-prefills at cached 0
   (K1 at visible 0, up to ~8.9k tokens), with the bucket of each chunk.
   Slice I quantizes A's bf16 weights to W4A8 (`quantize_model(bits=4)`:
   int4 decoder and lm_head, int8 vision tower) and serves them as C's
   stream: every decode product and one-row lm_head through K5-int4, none
   through K5's GEMV; its p50 / max print beside C's. Slice J (C's weights
   and stream, sampled): 12 chunks straight through against 6 through a
   StreamingSession, snapshot -> save_snapshot -> load_snapshot ->
   `resume_snapshot=` in a fresh engine -> 6 more, which must equal the
   straight run's; again with prerotate_arena=False (K3); then a 4-lane
   engine after 17 rounds moved lane by lane (lane 1 through a file) into a
   fresh one, whose next round must give lane 1 the same tokens; prints the
   snapshot's bytes and the ms of snapshot, save, load and restore. Slice
   K: `MultiStreamServer` over 4 lanes (W8A8, int8 arena) with 8 clients
   of 10 chunks each driven by its background thread (swaps > 0, every
   chunk delivered in order; rounds, swaps and their ms, round wall, frames
   /s), then again with an engine_factory and one injected device fault:
   one recovery, no chunk lost, the tokens equal to the unfaulted run's
   counted. Slice L (after C, on its W8A8 weights; kv_quant="int8",
   greedy, window 4): speculative decoding, 8 chunks, each run from the
   autoregressive run's state (snapshot / restore) four ways: the
   autoregressive chunk, then spec with no draft, an adversarial draft and
   a clairvoyant one (the autoregressive tokens); tokens equal, or parting
   only where that step's top-two penalised-logit gap is under 2 r max
   |logit| (it prints how many such steps it saw); fewer rounds with the clairvoyant draft than with none; an
   eviction; every verify attention through K2-verify (L launches a
   round), K1 L a chunk, K5 tiled at the verify's 8 rows. Slice M
   (training): the `Trainer` at Qwen2.5-VL-7B widths with the decoder cut
   to 4 layers (embed, lm_head and the frozen tower whole), random bf16
   weights, over a `StreamDataset` of one synthetic 476x840 10-second clip
   (raw frames in a .npz, read by `_RawClip` bound in place of ingest's
   FFmpeg reader: the card's machine has no FFmpeg libraries; ~510 vision
   tokens a second, one phrase a second: the 8192 bucket),
   grad_accum 2, max_steps 2, remat "full", prefetch 2, no save: finite
   losses and gradient norms, every attention through K1 (twice a layer a
   micro-step) and K1-bwd, CE-row once a 2048-row chunk; it prints the
   micro-step time, tokens/s (over the example's tokens, its labeled
   tokens and the padded bucket), peak memory beside the reckoned one and
   K1-bwd's and CE-row's device time a call. Then a resume check at narrow
   widths (hidden 512, head_dim 128, 2 layers, vocab 4096): 6 micro-steps
   straight through against 4, a checkpoint and a fresh Trainer for the
   last 2, bitwise. Slice N (run first, on slice A's bf16 weights, raw
   clips bound as in M): the evaluation harnesses, the LiveCC baseline, the
   demo and the CLI: `mcq_predict_batch` over 8 questions with mixed grids,
   `VQAChat.generate` on an 8-frame video message (8 new tokens),
   `infstream.generate_segments` (4 chunks, then a resume for 2), the
   livesports streaming and livecc generators (3 chunks each),
   `stream_segments` through a `LiveCaptionServer` to one SSE client on
   localhost (3 chunks), a 2-lane `MultiLiveCaptionServer` (3 rounds), each with its
   launch counts reset before it (its attention through K1 and K2 alone);
   and `python -m streaming_vlm_tpu_torch soak` (random 3B W8A8, the CLI's
   120 chunks) in a process started before the mutants' checks: exit 0,
   constant occupancy, K1 and K2 alone and every W8A8 product through K5.

The second-to-last line is a JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# K1 (bf16) vs the plain f32-math version on the same bf16 unit-normal
# inputs: both round the output to bf16; K1 also rounds the scaled q and P
# to bf16 for the tensor cores (each a relative error <= 2^-9 per term, which
# moves an output by up to ~2^-8.8 of the largest |ref| when emulated in
# PyTorch at T <= 200). So one bf16 ulp of each value plus one bf16 ulp of
# the largest |ref|: at visible 9600 the limit for small values is ~7e-4,
# where a typical |out| is ~0.017
K1_RTOL, K1_ATOL_FRAC = 2.0**-7, 2.0**-7
# the decode kernels (K2, K3, K4 merged) vs their plain versions: every step
# before the output's bf16 rounding is f32 in both (K3 rounds the
# dequantized and the rotated K to bf16 exactly where the plain version
# does), so they may differ by one bf16 ulp of each value (<= 2^-7 |ref|),
# plus 2^-12 of the largest |ref| for f32 summation noise near zero
DEC_RTOL, DEC_ATOL_FRAC = 2.0**-7, 2.0**-12
# K4's f32 partials vs the plain f32 sums of the same bf16 inputs, taken in
# another order
PART_TOL = 1e-3
# 7B-width streaming forward (kernels, bf16, REF_LAYERS decoder layers) vs
# the plain oracle in f32, as max |diff| of the last-token logits over max
# |oracle logit|: the kernel path may be at most REF_NOISE_FACTOR times as
# far from the f32 oracle as the plain bf16 path is (bf16 rounding of the
# residual stream and of the logits alone costs ~2e-2 here; over the int8
# arena the plain path's error includes the quantization)
REF_LAYERS = 4
N_CHUNKS = 18  # slice length: past visual_round=16, so eviction runs (chunks 16 and 17)
REF_NOISE_FACTOR = 2.0
MUTANT_BUILDS = 8  # mutant copies whose kernels build at once (most compile one source)
MUTANT_RUNS = 6  # mutant copies whose checks run at once on the card
TRACE_PAD_S = 0.05  # host time between a trace's start or end and the traced calls
# the H100 SXM's published peaks (dense bf16 and int8, f32 outside the
# tensor cores, HBM3)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
# f32 operations K3's dtype chain keeps off the tensor cores, per (visible
# slot, kv head): the angles (3 products, 2 sums per channel pair) and a
# sincosf per pair (counted as 24: a 3-FMA range reduction, two degree-4
# polynomials and the quadrant fix; append-range angles past 105615 take
# a longer path), K dequantized (128 products) and rotated (4 products and
# 2 sums per pair), V dequantized (128 products); P.V is 2 G HD more
K3_F32_OPS_PER_ROW = 64 * (5 + 24) + 128 + 64 * 6 + 128
# K1-bwd's mutant below: the bits of a packed pair of bf16 (rows c, c + 1 of
# a row tile, c = 16 kk + 8 (e / 2) + 2 (lane % 4)) kept, the row of the
# group's last head (row % G == G - 1) cleared
_LAST_HEAD_OUT = ("((16 * kk + 8 * (e >> 1) + 2 * (lane % 4)) % G == G - 1 ? 0xFFFF0000u : ~0u) & "
                  "((16 * kk + 8 * (e >> 1) + 2 * (lane % 4) + 1) % G == G - 1 ? 0x0000FFFFu : ~0u)")
# deliberate faults that phase 3 must reject: name -> (the kernel, or
# kernels, whose checks alone must fail, file under streaming_vlm_tpu_torch/,
# text, replacement (or tuples of texts and their replacements, each text
# once in the file), a text every failed check must contain, or a tuple of
# texts one of which it must contain, or None). A check belongs to the
# kernels its label names before the first space ("K2+K4 merged": K4's
# partials merged with the small block against K2).
MUTANTS = {
    "fast-math sin/cos": (
        "K3", "csrc/decode_attention_raw.cu",
        "sincosf(ang, &sn, &cs);",
        "__sincosf(ang, &sn, &cs);", None,
    ),
    "dequantized K not rounded to bf16": (
        "K3", "csrc/decode_attention_raw.cu",
        "k[e] = round_bf16(__fmul_rn(s8(w, e), scale));",
        "k[e] = __fmul_rn(s8(w, e), scale);", None,
    ),
    "K scales rounded to bf16": (
        "K3", "csrc/decode_attention_raw.cu",
        "kscale = QUANT ? s_ks[j * Hkv + kvh] : 1.f;",
        "kscale = QUANT ? round_bf16(s_ks[j * Hkv + kvh]) : 1.f;", None,
    ),
    "a raw-arena split drops its last slot": (
        "K3", "csrc/decode_attention_raw.cu",
        "min(split_rows, visible_len - row0);",
        "min(split_rows, visible_len - row0) - 1;", None,
    ),
    "K tail dropped": (
        "K5", "ops/quant.py",
        "mt, nt, kb = -(-M // GEMM_BM), -(-N // bn), -(-K // GEMM_BK)",
        "mt, nt, kb = -(-M // GEMM_BM), -(-N // bn), K // GEMM_BK", "'K': 3420",
    ),
    "activations truncated, not rounded half to even": (
        "K5", "csrc/int8_gemm.cu",
        "const float r = rintf(__fdiv_rn(x, sx));",
        "const float r = truncf(__fdiv_rn(x, sx));", None,
    ),
    "self-block causal limit off by one": (
        "K1", "csrc/prefill_attention.cu",
        "return key <= t;",
        "return key < t;", None,
    ),
    "raw-mode rotation sign flipped": (
        "K1", "csrc/prefill_attention.cu",
        "o1[e] = __fsub_rn(",
        "o1[e] = __fadd_rn(", "'mode': 'raw'",
    ),
    "merge drops a split row tile's last partial": (
        "K1", "csrc/prefill_attention.cu",
        "p0 = mg[2], n = mg[3];",
        "p0 = mg[2], n = mg[3] - 1;", None,
    ),
    # K1's pipelined loop: the next tile's S = Q K^T issued over the stage
    # of the tile whose P . V is pending (a stage index off by one); O's
    # rescale skipped where a row's alpha is below 1 but not below 1/2 (the
    # skip is exact only where every alpha is 1)
    "K1: the pipelined S of the next tile reads the current stage's K": (
        "K1", "csrc/prefill_attention.cu",
        "const unsigned char* k_next = sK + stage * KV_BYTES;",
        "const unsigned char* k_next = sK + pv_stage * KV_BYTES;", None,
    ),
    "K1: the rescale skip taken when a row's alpha is below 1": (
        "K1", "csrc/prefill_attention.cu",
        "if (__any_sync(0xffffffffu, alpha_a != 1.f || alpha_b != 1.f)) {",
        "if (__any_sync(0xffffffffu, alpha_a < 0.5f || alpha_b < 0.5f)) {", None,
    ),
    "plan: a CTA's last segment runs one key tile past its share": (
        "K1", "ops/attention.py",
        "min(hi, starts[i + 1]) - starts[i]",
        "min(hi + 1, starts[i + 1]) - starts[i]", None,
    ),
    "delta-row mask off by one": (
        "K2", "csrc/decode_attention.cu",
        "jj < extra_visible",
        "jj <= extra_visible", None,
    ),
    "a split drops its last slot": (
        ("K2", "K4"), "csrc/decode_attention.cu",
        "min(split_rows, visible_len - row0);",
        "min(split_rows, visible_len - row0) - 1;", None,
    ),
    # the lane forms: each must fail its lane checks alone
    "K1 lanes: a lane reads lane 0's length": (
        "K1", "csrc/prefill_attention.cu",
        "arena ? vis[segs[si * SEG_INTS] / Hkv] : 0;",
        "arena ? vis[0] : 0;", "'lanes'",
    ),
    "K2 lanes: a split past a lane's length is not skipped": (
        "K2", "csrc/decode_attention.cu",
        "  if (!small && (int)blockIdx.x >= n_splits) return;  // past this lane's visible slots\n",
        "", "'lanes'",
    ),
    "K3 lanes: a lane reads lane 0's length": (
        "K3", "csrc/decode_attention_raw.cu",
        "lane_visible(vis_lanes, vis_host, b, ",
        "lane_visible(vis_lanes, vis_host, 0, ", "'lanes'",
    ),
    "lane-strided counters left unreset": (
        ("K2", "K3"), "csrc/decode_common.cuh",
        "if (threadIdx.x == 0) counters[head] = 0;",
        "if (threadIdx.x == 0) counters[kvh] = 0;", "'lanes'",
    ),
    # K2-verify: query t also sees the next token's self row (not past the
    # staged rows); P.V without P_lo (P in bf16 alone); the fold of all T x G
    # rows reading query 0's (m, l) for every query. Each must fail
    # K2-verify's checks alone (those labelled "K2-verify+K2", against K2
    # row by row, belong to both)
    "K2-verify: query t sees self row t + 1": (
        "K2-verify", "csrc/verify_attention.cu",
        "j <= e_delta + tq[e / 2])",
        "j <= e_delta + tq[e / 2] + 1)", None,
    ),
    "K2-verify: P.V without P_lo": (
        "K2-verify", "csrc/verify_attention.cu",
        "const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);",
        "const __nv_bfloat162 l = __floats2bfloat162_rn(0.f, 0.f);", None,
    ),
    "K2-verify: the fold reads query 0's (m, l) for every query": (
        "K2-verify", "csrc/verify_attention.cu",
        "const float *mr = sm + r, *lr = sl + r;",
        "const float *mr = sm + r % G, *lr = sl + r % G;", None,
    ),
    # K5-int4 (W4A8): negative high nibbles read as 8..15 (n + 8 where the
    # offset form is n ^ 8); a split tile's last part folding its groups in
    # reverse; a split tile's counter left unreset (the next call's parts
    # never see a last arrival)
    "int4: high nibbles not sign-extended": (
        "K5-int4", "csrc/int4_gemv.cu",
        "return ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;",
        "return ((v >> 4) & 0x0F0F0F0Fu) + 0x08080808u;", None,
    ),
    "int4: a split tile's groups folded out of order": (
        "K5-int4", "csrc/int4_gemv.cu",
        "const float* rg = rbuf + gi * rec;",
        "const float* rg = rbuf + (cn - 1 - gi) * rec;", "'slabs': ",
    ),
    "int4: a split tile's counter left unreset": (
        "K5-int4", "csrc/int4_gemv.cu",
        "if (lane == 0) counters[tile] = 0;  // ready for the next call",
        "", "'slabs': ",
    ),
    # training: K1-bwd's causal edge off by one (a key no longer sees its own
    # token's rows; P and dS, so every gradient); K1-bwd's dQ fold skipping
    # the last key block of each row tile (its dq checks alone); K1-bwd's
    # dK and dV leaving out the rows of each kv head's last query head, P's
    # fragments before dV and dS's after it went to shared memory for dQ
    # (its dk and dv checks alone); K1's merge pass writes a split row's
    # log-sum-exp without its log2(l) (only the LSE checks of split rows may
    # fail); CE-row's block reduction skips the last warp's (max, sum);
    # CE-row writes every fourth probability under 1e-7 as 0
    "K1-bwd: the causal edge off by one": (
        "K1-bwd", "csrc/attention_bwd.cu",
        "return key <= t;",
        "return key < t;", None,
    ),
    "K1-bwd: the dQ fold skips the last key block of each row tile": (
        "K1-bwd", "csrc/attention_bwd.cu",
        "bulk_reduce_add_f32(dst, src, DQ_FLOATS * 4);",
        "if (n != (min(T, (m + 1) * BT) - 1) / BN) bulk_reduce_add_f32(dst, src, DQ_FLOATS * 4);",
        "'grad': 'dq'",
    ),
    "K1-bwd: a kv head's last query head left out of dK and dV": (
        "K1-bwd", "csrc/attention_bwd.cu",
        ("pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);",
         "named_barrier_arrive(1 + 2 * wg + b, CONSUMERS * 128);"),
        ("pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]) & " + _LAST_HEAD_OUT
         + ";",
         "named_barrier_arrive(1 + 2 * wg + b, CONSUMERS * 128);\n"
         "      for (int kk = 0; kk < ROWS / 16; ++kk)\n"
         "        for (int e = 0; e < 4; ++e) da[kk][e] &= " + _LAST_HEAD_OUT + ";"),
        ("'grad': 'dk'", "'grad': 'dv'"),
    ),
    "K1 lse: a split row's log-sum-exp without log2(l)": (
        "K1", "csrc/prefill_attention.cu",
        "lse[((size_t)b * T + t) * H + kvh * G + g] = m + log2f(den);",
        "lse[((size_t)b * T + t) * H + kvh * G + g] = m;", "'out': 'lse'",
    ),
    "K1 full-block: the plan drops the block's last key tile": (
        "K1", "ops/attention.py",
        "units = np.concatenate([np.tile(prefill_units(T, G, v)[0] + n_self, Hkv) for v in vis])",
        "units = np.concatenate([np.tile(prefill_units(T, G, v)[0] + n_self - int(not self_block), "
        "Hkv) for v in vis])", "'mode': 'full-block'",
    ),
    "K1-bwd full-block: the first row tile skipped": (
        "K1-bwd", "csrc/attention_bwd.cu",
        "const int n_tiles = FULL ? M : M - n * BN / BT;",
        "const int n_tiles = FULL ? M - 1 : M - n * BN / BT;", "'mode': 'full-block'",
    ),
    # K1-bwd's clusters (full-block mode): each producer multicasts the
    # peer's half of Q's and dO's columns into its own half (the head dim
    # permuted in both CTAs); rank 1 decodes the cluster's ticket to the
    # next kv head, so the two CTAs of a cluster load halves of different
    # heads (every (block, kv head) still once: at the checked shapes every
    # cluster is resident, so no fold waits on a cluster that cannot start)
    "K1-bwd full-block: the multicast fills each CTA's half with the peer's columns": (
        "K1-bwd", "csrc/attention_bwd.cu",
        "const int c0 = 64 * (int)rank;",
        "const int c0 = 64 * (int)peer;", "'mode': 'full-block'",
    ),
    "K1-bwd full-block: rank 1 decodes the cluster's ticket to the next kv head": (
        "K1-bwd", "csrc/attention_bwd.cu",
        "job = (2 * (ticket / Hkv) + (int)rank) * Hkv + ticket % Hkv;",
        "job = (2 * (ticket / Hkv) + (int)rank) * Hkv + (ticket + (int)rank) % Hkv;",
        "'mode': 'full-block'",
    ),
    "CE-row: the reduction skips the last warp": (
        "CE-row", "csrc/linear_ce.cu",
        "for (int w = 1; w < WARPS; ++w)",
        "for (int w = 1; w < WARPS - 1; ++w)", None,
    ),
    "CE-row: probabilities under 1e-7 flushed to zero": (
        "CE-row", "csrc/linear_ce.cu",
        "v.x = (expf(v.x - m) / s - (j == tgt ? 1.f : 0.f)) * mk;",
        "v.x = ((expf(v.x - m) / s < 1e-7f ? 0.f : expf(v.x - m) / s) - (j == tgt ? 1.f : 0.f)) "
        "* mk;", None,
    ),
}
# the lane forms' checks (phase 3): K2 and K3 at B in {1, 4, 8} lanes with
# these per-lane visible lengths (empty lanes, lanes shorter than one split,
# the whole arena), K1 at slice D's 6 lanes with these insert points
LANE_VISIBLE = {1: ((9000,), (0,)), 4: ((1, 4501, 0, 100), (10240, 641, 9000, 1)),
                8: ((0, 1, 100, 641, 4501, 9000, 10240, 9000),)}
K1_LANE_INSERT_AT = (0, 1, 641, 4501, 9000, 9600)
# multi-stream slices: lanes, rounds, rounds in which the last lane idles
MS_ROUNDS = 18  # past visual_round=16: eviction in rounds 16 and 17
MS_LAYERS = 14  # the decoder of slices D-F, J and K, cut from 28 to keep the run in its limit
MS_IDLE_ROUNDS = (3, 11)
_FAILED = []  # the checks of phase 3 that failed
_TIMED = True  # False: phase 3's checks without its timings (the mutant copies)

SRC = {  # kernel -> (source, the TPU kernel's pallas_call it replaces)
    "streaming_prefill_attention": (
        "streaming_vlm_tpu_torch/csrc/prefill_attention.cu",
        "streaming_vlm_tpu/ops/attention.py:854",
    ),
    "streaming_decode_attention_full": (
        "streaming_vlm_tpu_torch/csrc/decode_attention.cu",
        "streaming_vlm_tpu/ops/attention.py:280",
    ),
    "streaming_decode_attention_int8": (
        "streaming_vlm_tpu_torch/csrc/decode_attention_raw.cu",
        "streaming_vlm_tpu/ops/attention.py:627",
    ),
    "streaming_decode_attention": (
        "streaming_vlm_tpu_torch/csrc/decode_attention.cu",
        "streaming_vlm_tpu/ops/attention.py:362",
    ),
    # K2-verify: no pallas_call; the JAX package's verify attention is XLA
    # (`_gqa_attention_multi` from the streaming forward's delta path)
    "streaming_verify_attention": (
        "streaming_vlm_tpu_torch/csrc/verify_attention.cu",
        "streaming_vlm_tpu/models/qwen25_vl/language.py:106",
    ),
    "int8_gemm": (
        "streaming_vlm_tpu_torch/csrc/int8_gemm.cu",
        "tools/profile_s8_mxu.py:78",
    ),
    # K1-bwd: no pallas_call; the JAX package trains through XLA's autodiff
    # of `_gqa_attention_chunked`
    "attention_bwd": (
        "streaming_vlm_tpu_torch/csrc/attention_bwd.cu",
        "streaming_vlm_tpu/models/qwen25_vl/language.py:147",
    ),
    # K1's and K1-bwd's full-block modes: no pallas_call; ring attention's
    # steps over a key block wholly before the queries (XLA einsums, and
    # their autodiff)
    "full_block_attention": (
        "streaming_vlm_tpu_torch/csrc/prefill_attention.cu",
        "streaming_vlm_tpu/parallel/ring.py:45",
    ),
    "attention_bwd_full": (
        "streaming_vlm_tpu_torch/csrc/attention_bwd.cu",
        "streaming_vlm_tpu/parallel/ring.py:45",
    ),
    # CE-row: no pallas_call; the row pass of `_fused_ce_pass` (XLA)
    "ce_rows": (
        "streaming_vlm_tpu_torch/csrc/linear_ce.cu",
        "streaming_vlm_tpu/train/step.py:37",
    ),
    # K5-int4: no pallas_call; the JAX package's qdot4 (XLA) below 32 rows
    "int8_gemm/int4": (
        "streaming_vlm_tpu_torch/csrc/int4_gemv.cu",
        "streaming_vlm_tpu/ops/quant.py:126",
    ),
}


def _median_ms(fn, reps: int = 10, batch: int = 10) -> float:
    """Median over `reps` of the mean time of `batch` back-to-back calls,
    from CUDA events (warmed up first)."""
    import torch

    if not _TIMED:
        return math.nan
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _device_ms(fn, n: int = 20) -> float:
    """Device time of one call of fn: the CUDA kernels' time over n calls
    traced with torch.profiler, divided by n (no host time; the CUDA-event
    time of _median_ms includes the host's when it issues slower than the
    card runs)."""
    import torch

    if not _TIMED:
        return math.nan
    fn()
    torch.cuda.synchronize()
    prof = _traced_calls(fn, n)
    total = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    return total / 1e3 / n


def _traced_calls(fn, n: int):
    """A torch.profiler trace of n calls of fn. The calls start and end
    TRACE_PAD_S inside the trace window: the profiler keeps only device
    records whose card timestamps fall inside the host's window, so a
    kernel issued right at its start or end can be dropped from the trace."""
    import torch

    with _profiler() as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    return prof


def _kernels_per_call(fn, kernel: str, n: int = 10, tries: int = 3) -> float:
    """CUDA kernels launched per call of fn, from a torch.profiler trace of
    n calls (warmed up first); nan when untimed. fn launches `kernel` at
    least once a call, so a trace holding fewer than n of its records lost
    some: it is taken again, up to `tries` times. If every trace lost
    records, the kernels of the last one are counted per record of `kernel`
    (1 when `kernel` is all that ran)."""
    import torch

    if not _TIMED:
        return math.nan
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        names = [e.name for e in _traced_calls(fn, n).events()
                 if str(e.device_type).endswith("CUDA") and "memcpy" not in e.name.lower()
                 and "memset" not in e.name.lower()]
        mine = sum(kernel in name for name in names)
        if mine >= n:
            return len(names) / n
        print(f"  trace {attempt + 1} of {n} calls holds {mine} {kernel} records of {n} "
              f"({len(names)} kernel records in all): the profiler lost records")
    return len(names) / mine if mine else 0.0


def _check(name, got, want, cases, atol, rtol):
    """|got - want| <= atol + rtol |want| elementwise; prints the largest
    error and its largest ratio to the limit. A failure is recorded in
    _FAILED (phase 3 fails at its end, after printing every case)."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = (atol + rtol * want.abs()).clamp_min(1e-30)
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    e = float(err.max()) if err.numel() else 0.0
    r = float((err / bound).max()) if err.numel() else 0.0
    print(f"  {name} {cases}: max_abs_err={e:.3e} err/limit={r:.3f} "
          f"(atol={atol:.3e}, rtol={rtol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        _FAILED.append(f"{name} {cases}")
    return e


def _check_k1(got, want, cases):
    """K1's bf16 output: one bf16 ulp of each value, plus K1_ATOL_FRAC of
    the largest |want|."""
    atol = K1_ATOL_FRAC * float(want.float().abs().max())
    return _check("K1", got, want, cases, atol, K1_RTOL)


def _check_decode(name, got, want, cases):
    """A decode kernel's bf16 output: one bf16 ulp of each value, plus
    DEC_ATOL_FRAC of the largest |want|."""
    atol = DEC_ATOL_FRAC * float(want.float().abs().max())
    return _check(name, got, want, cases, atol, DEC_RTOL)


def _check_equal(name, got, want, cases):
    """Bitwise equality (a K5 check); prints the count of differing values
    and the largest difference. A failure is recorded in _FAILED."""
    import torch

    torch.cuda.synchronize()
    ok = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    diff = (got.double() - want.double()).abs() if got.shape == want.shape else None
    n = int((diff > 0).sum()) if diff is not None else -1
    e = float(diff.max()) if diff is not None and diff.numel() else 0.0
    print(f"  {name} {cases}: bitwise, {n} values differ, max_abs_err={e:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _FAILED.append(f"{name} {cases}")
    return e


def _bound(nbytes: float, ops: float, peak: float = BF16_FLOPS, f32_ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type (bf16
    unless given; f32_ops more at the f32 rate outside the tensor cores).
    Returns (ms, by)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak + f32_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _sdpa_inputs(q, ks, vs, mask):
    """[T, H, hd] queries, [S, Hkv, hd] keys/values and a [T, S] mask in
    F.scaled_dot_product_attention's layout (kv heads repeated per query
    head), prepared outside the timed call."""
    H, Hkv = q.shape[1], ks.shape[1]
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None].contiguous()  # noqa: E731
    return q.transpose(0, 1)[None].contiguous(), rep(ks), rep(vs), mask


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    H, Hkv, hd, C = 28, 4, 128, 10240
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def sdpa_ms(q, ks, vs, mask):
        qq, kk, vv, mm = _sdpa_inputs(q, ks, vs, mask)
        return _median_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm))

    stats = {}
    ka, va = rn(C, Hkv, hd), rn(C, Hkv, hd)
    ang = torch.randn(C, hd // 2, generator=g, device=dev)
    acos2 = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    asin2 = torch.cat([ang.sin(), ang.sin()], -1).contiguous()

    # ---- K1: chunk prefill. T * G off the 128-row tile (T=200), visible
    # lengths off the 128-key tile (4001), the main path's 9600 and the
    # whole arena, both arena modes
    k1_err = 0.0
    for T in (640, 200, 64):
        q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
        for vis in (0, 4001, C - 640, C):
            for mode, (c2, s2) in (("prerotated", (None, None)), ("raw", (acos2, asin2))):
                out = A.streaming_prefill_attention(q, ka, va, c2, s2, ks, vs, vis)
                ref = A.prefill_attention_plain(q, ka, va, c2, s2, ks, vs, vis)
                k1_err = max(k1_err, _check_k1(out, ref, dict(T=T, visible_len=vis, mode=mode)))
    # a new (T, visible_len) makes a new plan; its copy to the card must not
    # make the host wait for the work queued before it
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 777)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  K1 plan copied to the card without a host sync: ok")
    T, vis = 640, C - 640
    q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    pre = lambda: A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, vis)  # noqa: E731
    raw = lambda: A.streaming_prefill_attention(q, ka, va, acos2, asin2, ks, vs, vis)  # noqa: E731
    k1 = dict(ms=_median_ms(pre), device_ms=_device_ms(pre),
              plain_ms=_median_ms(lambda: A.prefill_attention_plain(q, ka, va, None, None, ks, vs, vis)),
              ms_raw_mode=_median_ms(raw), device_ms_raw_mode=_device_ms(raw))
    mask = torch.cat([torch.ones(T, vis, dtype=torch.bool, device=dev),
                      torch.ones(T, T, dtype=torch.bool, device=dev).tril()], 1)
    k1["library_ms"] = sdpa_ms(q, torch.cat([ka[:vis], ks]), torch.cat([va[:vis], vs]), mask)
    flops = 4 * T * H * hd * (vis + (T + 1) / 2)  # QK^T and PV over the visible keys
    k1["bound_ms"], k1["bound_by"] = _bound(
        _nbytes(q, ka[:vis], va[:vis], ks, vs) + _nbytes(q), flops)
    k1["tflops"] = flops / ((k1["device_ms"] or k1["ms"]) * 1e-3) / 1e12  # device time on the card
    q64, ks64, vs64 = q[:64].contiguous(), ks[:64].contiguous(), vs[:64].contiguous()
    k1["t64_device_ms"] = _device_ms(
        lambda: A.streaming_prefill_attention(q64, ka, va, None, None, ks64, vs64, vis))
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1["plan"] = {f"T={t}": dict(zip(("ctas", "segments", "merges"), (
        p.n_ctas, len(p.segs), len(p.merges)))) for t in (640, 64)
        for p in [A.prefill_plan(t, H // Hkv, Hkv, vis, n_sms)]}
    rec = _phase_k1_recompute(g)
    k1["recompute"] = rec
    stats["streaming_prefill_attention"] = dict(max_abs_err=max(k1_err, rec["max_abs_err"]), **k1)
    print(f"  K1 T={T} visible_len={vis}: kernel {k1['ms']:.4f} ms (device {k1['device_ms']:.4f} ms, "
          f"{k1['tflops']:.1f} TFLOP/s), raw mode {k1['ms_raw_mode']:.4f} ms (device "
          f"{k1['device_ms_raw_mode']:.4f}), plain {k1['plain_ms']:.4f} ms, sdpa "
          f"{k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}); "
          f"T=64 device {k1['t64_device_ms']:.4f} ms; plan {k1['plan']}")

    # ---- K2: decode over the pre-rotated arena + delta + self
    e_delta = 20
    k2_err = 0.0
    qd = rn(H, hd)
    ksm, vsm = rn(e_delta + 1, Hkv, hd), rn(e_delta + 1, Hkv, hd)
    # visible 0 (chunk 0: the small block alone), one slot, lengths off the
    # host's split (641, 4501), the main path's 9000 and the whole arena
    for vis in (0, 1, 641, 4501, 9000, C):
        for evis in (0, 7, 20):
            args = (qd, ka, va, ksm, vsm, vis, evis)
            out = A.streaming_decode_attention_full(*args, e_delta=e_delta)
            ref = A.decode_attention_plain(*args, e_delta=e_delta)
            k2_err = max(k2_err, _check_decode("K2", out, ref, dict(visible_len=vis, extra_visible=evis)))
    # a small block longer than the kernel's 160-row tile (K2's and K3's)
    kbig, vbig = rn(200, Hkv, hd), rn(200, Hkv, hd)
    args = (qd, ka, va, kbig, vbig, 500, 60)
    k2_err = max(k2_err, _check_decode(
        "K2", A.streaming_decode_attention_full(*args, e_delta=199),
        A.decode_attention_plain(*args, e_delta=199), dict(visible_len=500, e1=200, extra_visible=60)))
    vis, evis = 9000, 7
    args = (qd, ka, va, ksm, vsm, vis, evis)
    k2 = dict(
        ms=_median_ms(lambda: A.streaming_decode_attention_full(*args, e_delta=e_delta)),
        device_ms=_device_ms(lambda: A.streaming_decode_attention_full(*args, e_delta=e_delta)),
        plain_ms=_median_ms(lambda: A.decode_attention_plain(*args, e_delta=e_delta)),
    )
    # the split pass and its combine are one launch: device time by visible length
    k2["device_ms_by_visible"] = {
        v: _device_ms(lambda: A.streaming_decode_attention_full(qd, ka, va, ksm, vsm, v, evis,
                                                                e_delta=e_delta))
        for v in (640, 4500, 9000)}
    k2["split_by_visible"] = {v: A.decode_split_size(v, Hkv, A.sm_count(torch.device(dev)))
                              for v in (640, 4500, 9000)}
    col = torch.arange(e_delta + 1, device=dev)
    small_mask = (col < evis) | (col >= e_delta)
    mask = torch.cat([torch.ones(vis, dtype=torch.bool, device=dev), small_mask])[None]
    k2["library_ms"] = sdpa_ms(qd[None], torch.cat([ka[:vis], ksm]), torch.cat([va[:vis], vsm]), mask)
    k2["bound_ms"], k2["bound_by"] = _bound(
        _nbytes(qd, ka[:vis], va[:vis], ksm, vsm, qd), 4 * H * hd * (vis + e_delta + 1))
    stats["streaming_decode_attention_full"] = dict(max_abs_err=k2_err, **k2)
    print(f"  K2 visible_len={vis} extra_visible={evis}: kernel {k2['ms']:.4f} ms (device "
          f"{k2['device_ms']:.4f} ms), plain {k2['plain_ms']:.4f} ms, sdpa {k2['library_ms']:.4f} ms, "
          f"bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}); device ms by visible length "
          f"{k2['device_ms_by_visible']} (split {k2['split_by_visible']}; one launch each)")

    # ---- K3: decode over the raw arena in storage form (int8 + scales, or bf16)
    kw = dict(e_delta=e_delta, mrope_section=(16, 24, 24), rope_theta=1e6)
    (kq, kscale), (vq, vscale) = quantize_kv(ka), quantize_kv(va)
    forms = {"int8": (kq, kscale, vq, vscale), "bf16": (ka, None, va, None)}

    def positions(top):
        # mRoPE-shaped per-slot positions: shrink mode keeps them below C;
        # append mode grows them without bound (~1e5 after a long stream)
        p = torch.rand(C, 3, generator=g, device=dev) * torch.tensor([C, 50.0, 50.0], device=dev)
        if top:
            p = top + torch.rand(C, 3, generator=g, device=dev) * C
        return p.floor().contiguous()

    pos_ranges = {"shrink": positions(0), "append": positions(100_000)}
    k3_err = 0.0
    for form, arena in forms.items():
        for rng_name, pos_t in pos_ranges.items():
            # visible 0 (the small block alone), one slot, lengths off the
            # host's split (100, 641, 4501), the main path's 9000 and the
            # whole arena
            for vis in (0, 1, 100, 641, 4501, 9000, C):
                for evis in (0, 7, 20):
                    a3 = (qd, *arena, pos_t, ksm, vsm, vis, evis)
                    out = A.streaming_decode_attention_int8(*a3, **kw)
                    ref = A.decode_attention_int8_plain(*a3, **kw)
                    k3_err = max(k3_err, _check_decode("K3", out, ref, dict(
                        form=form, positions=rng_name, visible_len=vis, extra_visible=evis)))
            # a small block longer than the kernel's 160-row tile
            a3 = (qd, *arena, pos_t, kbig, vbig, 500, 60)
            kwb = dict(kw, e_delta=199)
            k3_err = max(k3_err, _check_decode(
                "K3", A.streaming_decode_attention_int8(*a3, **kwb),
                A.decode_attention_int8_plain(*a3, **kwb),
                dict(form=form, positions=rng_name, visible_len=500, e1=200, extra_visible=60)))
    vis, evis = 9000, 7
    pos_t = pos_ranges["shrink"]
    ms_by_form, device_ms_by_form = {}, {}
    for form, arena in forms.items():
        a3 = (qd, *arena, pos_t, ksm, vsm, vis, evis)
        ms_by_form[form] = _median_ms(lambda: A.streaming_decode_attention_int8(*a3, **kw))
        device_ms_by_form[form] = _device_ms(lambda: A.streaming_decode_attention_int8(*a3, **kw))
    a3 = (qd, *forms["int8"], pos_t, ksm, vsm, vis, evis)
    k3 = dict(ms=ms_by_form["int8"], ms_by_form=ms_by_form, device_ms=device_ms_by_form["int8"],
              device_ms_by_form=device_ms_by_form,
              plain_ms=_median_ms(lambda: A.decode_attention_int8_plain(*a3, **kw)),
              library_ms=None,
              kernels_per_call=_kernels_per_call(
                  lambda: A.streaming_decode_attention_int8(*a3, **kw), "decode_raw_kernel"))
    # split pass, small block and combine are one launch: device time by
    # visible length (int8), with the host's split at each
    k3["device_ms_by_visible"] = {
        v: _device_ms(lambda: A.streaming_decode_attention_int8(
            qd, *forms["int8"], pos_t, ksm, vsm, v, evis, **kw))
        for v in (640, 4500, 9000)}
    k3["split_by_visible"] = {v: A.decode_split_size(v, Hkv, A.sm_count(torch.device(dev)))
                              for v in (640, 4500, 9000)}
    k3_bytes = _nbytes(qd, kq[:vis], kscale[:vis], vq[:vis], vscale[:vis], pos_t[:vis], ksm,
                       vsm, qd)
    k3_f32 = Hkv * vis * (K3_F32_OPS_PER_ROW + 2 * (H // Hkv) * hd)  # + P.V
    k3_qk = 2 * H * hd * vis + 4 * H * hd * (e_delta + 1)  # arena Q.K, small block Q.K and P.V
    k3["bound_ms"], k3["bound_by"] = _bound(k3_bytes, k3_qk, f32_ops=k3_f32)
    k3["bytes_ms"] = _bound(k3_bytes, 0)[0]
    k3["f32_work_ms"] = k3_f32 / FP32_FLOPS * 1e3
    if _TIMED and k3["kernels_per_call"] != 1:
        _FAILED.append(f"K3 launches {k3['kernels_per_call']} kernels a call, not one")
    stats["streaming_decode_attention_int8"] = dict(max_abs_err=k3_err, **k3)
    print(f"  K3 visible_len={vis} extra_visible={evis}: kernel int8 {ms_by_form['int8']:.4f} ms "
          f"(device {device_ms_by_form['int8']:.4f} ms), bf16 {ms_by_form['bf16']:.4f} ms "
          f"(device {device_ms_by_form['bf16']:.4f} ms), plain (int8) {k3['plain_ms']:.4f} ms, "
          f"no single PyTorch call, bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}: bytes "
          f"{k3['bytes_ms']:.4f}, f32 work off the tensor cores {k3['f32_work_ms']:.4f}); "
          f"{k3['kernels_per_call']} kernel(s) a call; device ms by visible length "
          f"{k3['device_ms_by_visible']} (split {k3['split_by_visible']})")

    # ---- K4: the arena's partials; merged with the small block == K2
    k4_err = 0.0
    for vis in (0, 4501, 9000):
        got = A.streaming_decode_attention(qd, ka, va, vis)
        want = A.decode_attention_partials_plain(qd, ka, va, vis)
        for part, a, b in zip("mla", got, want):
            k4_err = max(k4_err, _check("K4", a, b, dict(visible_len=vis, part=part),
                                        PART_TOL, PART_TOL))
        for evis in (0, 7, 20):
            small = [(ksm[:e_delta], vsm[:e_delta],
                      (torch.arange(e_delta, device=dev) < evis)[None]),
                     (ksm[e_delta:], vsm[e_delta:], torch.ones(1, 1, dtype=torch.bool, device=dev))]
            merged = A.decode_attention_merge(qd[None], small, ka, va, vis).reshape(H, hd)
            k2_out = A.streaming_decode_attention_full(qd, ka, va, ksm, vsm, vis, evis,
                                                       e_delta=e_delta)
            _check_decode("K2+K4 merged", merged, k2_out,
                          dict(visible_len=vis, extra_visible=evis))
    vis = 9000
    k4 = dict(ms=_median_ms(lambda: A.streaming_decode_attention(qd, ka, va, vis)),
              device_ms=_device_ms(lambda: A.streaming_decode_attention(qd, ka, va, vis)),
              plain_ms=_median_ms(lambda: A.decode_attention_partials_plain(qd, ka, va, vis)),
              library_ms=None)
    k4["bound_ms"], k4["bound_by"] = _bound(
        _nbytes(qd, ka[:vis], va[:vis]) + 4 * H * (hd + 2), 4 * H * hd * vis)
    stats["streaming_decode_attention"] = dict(max_abs_err=k4_err, **k4)
    print(f"  K4 visible_len={vis}: kernel {k4['ms']:.4f} ms (device {k4['device_ms']:.4f} ms), "
          f"plain {k4['plain_ms']:.4f} ms, "
          f"no single PyTorch call, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']})")
    stats["streaming_verify_attention"] = _phase_verify(g, ka, va, sdpa_ms)
    for name, lane_stats in _phase_lanes(g).items():
        stats[name]["lanes"] = lane_stats
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], lane_stats["max_abs_err"])
    stats["int8_gemm"] = _phase_k5(g)
    stats["int8_gemm"]["int4"] = _phase_k5_int4(g)
    stats["streaming_prefill_attention"]["lse"] = _phase_k1_lse(g, ka, va)
    ev = _phase_k1_eval(g)
    stats["streaming_prefill_attention"]["eval"] = ev
    stats["streaming_prefill_attention"]["max_abs_err"] = max(
        stats["streaming_prefill_attention"]["max_abs_err"], ev["max_abs_err"])
    stats["attention_bwd"] = _phase_k1_bwd(g)
    stats.update(_phase_full_block(g))
    stats["ce_rows"] = _phase_ce_rows(g)
    if _FAILED:
        raise AssertionError("kernels disagree with their plain versions: " + "; ".join(_FAILED))
    return stats


# K2-verify (phase 3): spec decode's verify widths, at the spec path's
# decode delta with the default budget (max_new 20 + k_pad 8)
# (T x G = 7, 14, 21, 56, 63, 112 query rows a kv head: 1, 1, 2, 4, 4, 7 m-tiles)
VERIFY_T = (1, 2, 3, 8, 9, 16)
VERIFY_E_DELTA = 28


def _phase_verify(g, ka, va, sdpa_ms) -> dict:
    """K2-verify against its plain version at K2's tolerance, and its rows
    against K2 called on each query with the small block cut to the rows
    that query sees, at the same tolerance (the tensor cores sum in another
    order than K2's f32 loop; "K2-verify+K2": a check of both kernels; at
    T = 1 the wrapper is K2 itself, so its checks carry both names and the
    rows' check is bitwise), over
    T in VERIFY_T, visible 0, 640 (on the host's split), 9000 and C -
    e_delta - T (off it), extra_visible 0, 5 and e_delta. Then its times at
    T = 8, visible 9000: CUDA events and device time, beside its plain
    version, SDPA with a boolean mask over the concatenated keys, K2 called
    T times, and its bound."""
    import torch

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    C, Hkv, hd = ka.shape
    H, e_delta = 28, VERIFY_E_DELTA

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def inputs(T):
        return rn(T, H, hd), rn(e_delta + T, Hkv, hd), rn(e_delta + T, Hkv, hd)

    def k2_rows(q, ksm, vsm):
        return [(q[t].contiguous(), ksm[: e_delta + t + 1], vsm[: e_delta + t + 1])
                for t in range(q.shape[0])]

    err = 0.0
    for T in VERIFY_T:
        q, ksm, vsm = inputs(T)
        label = "K2-verify" if T > 1 else "K2-verify+K2"
        for vis in (0, 640, 9000, C - e_delta - T):
            for evis in (0, 5, e_delta):
                args = (q, ka, va, ksm, vsm, vis, evis)
                cases = dict(T=T, visible_len=vis, extra_visible=evis)
                out = A.streaming_verify_attention(*args, e_delta=e_delta)
                err = max(err, _check_decode(label, out, A.verify_attention_plain(
                    *args, e_delta=e_delta), cases))
                k2 = torch.stack([A.streaming_decode_attention_full(
                    qt, ka, va, kt, vt, vis, evis, e_delta=e_delta)
                    for qt, kt, vt in k2_rows(q, ksm, vsm)])
                rows = dict(cases, rows="each row vs K2")
                if T == 1:
                    _check_equal("K2-verify+K2", out, k2, rows)
                else:
                    _check_decode("K2-verify+K2", out, k2, rows)
    T, vis, evis = 8, 9000, 5
    q, ksm, vsm = inputs(T)
    args = (q, ka, va, ksm, vsm, vis, evis)
    rows = k2_rows(q, ksm, vsm)

    def kern():
        return A.streaming_verify_attention(*args, e_delta=e_delta)

    def k2_x_t():
        return [A.streaming_decode_attention_full(qt, ka, va, kt, vt, vis, evis, e_delta=e_delta)
                for qt, kt, vt in rows]

    st = dict(T=T, visible_len=vis, extra_visible=evis, e_delta=e_delta, max_abs_err=err,
              ms=_median_ms(kern), device_ms=_device_ms(kern),
              plain_ms=_median_ms(lambda: A.verify_attention_plain(*args, e_delta=e_delta)),
              k2_x_T_ms=_median_ms(k2_x_t), k2_x_T_device_ms=_device_ms(k2_x_t))
    mask = torch.cat([torch.ones(T, vis, dtype=torch.bool, device=dev),
                      A.verify_small_mask(T, e_delta + T, evis, e_delta, dev)], 1)
    st["library_ms"] = sdpa_ms(q, torch.cat([ka[:vis], ksm]), torch.cat([va[:vis], vsm]), mask)
    keys = sum(vis + evis + t + 1 for t in range(T))  # the keys each query sees
    st["bound_ms"], st["bound_by"] = _bound(_nbytes(q, ka[:vis], va[:vis], ksm, vsm, q),
                                            4 * H * hd * keys)
    by_t = {}
    for t in (2, 16):
        qt, kt, vt = inputs(t)
        by_t[t] = _device_ms(lambda: A.streaming_verify_attention(
            qt, ka, va, kt, vt, vis, evis, e_delta=e_delta))
    st["device_ms_by_T"] = {2: by_t[2], 8: st["device_ms"], 16: by_t[16]}
    print(f"  K2-verify T={T} visible_len={vis} extra_visible={evis} e_delta={e_delta}: kernel "
          f"{st['ms']:.4f} ms (device {st['device_ms']:.4f} ms), K2 x {T} {st['k2_x_T_ms']:.4f} ms "
          f"(device {st['k2_x_T_device_ms']:.4f} ms), plain {st['plain_ms']:.4f} ms, sdpa "
          f"{st['library_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms ({st['bound_by']}); device "
          f"ms by T {st['device_ms_by_T']}")
    return st


# recompute mode (efficiency config (c), slice H): the whole window re-
# prefills at cached == 0, so K1 sees the causal self block alone at up to
# the largest bucket slice H takes; its plain version runs in row blocks
K1_RECOMPUTE_T = 10240
K1_PLAIN_ROWS = 1024


def _phase_k1_recompute(g) -> dict:
    """K1 at visible 0 with T = K1_RECOMPUTE_T (pre-rotated mode: the arena
    is not read) against its plain version, computed K1_PLAIN_ROWS query
    rows at a time: rows [r0, r1) attend keys [0, r0) as a fully visible
    "arena" and [r0, r1) causally, the same joint softmax. Times beside
    SDPA (is_causal) and the bound."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    H, Hkv, hd, T = 28, 4, 128, K1_RECOMPUTE_T

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    ka, va = rn(64, Hkv, hd), rn(64, Hkv, hd)  # an arena that visible 0 never reads
    out = A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 0)

    def plain():
        parts = [A.prefill_attention_plain(q[r0:r0 + K1_PLAIN_ROWS], ks, vs, None, None,
                                           ks[r0:r0 + K1_PLAIN_ROWS], vs[r0:r0 + K1_PLAIN_ROWS], r0)
                 for r0 in range(0, T, K1_PLAIN_ROWS)]
        return torch.cat(parts)

    err = _check_k1(out, plain(), dict(T=T, visible_len=0, mode="prerotated, recompute"))
    torch.cuda.empty_cache()
    f = lambda: A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 0)  # noqa: E731
    r = dict(T=T, visible_len=0, max_abs_err=err, ms=_median_ms(f, reps=5, batch=3),
             device_ms=_device_ms(f, n=5), plain_ms=_median_ms(plain, reps=2, batch=1))
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None].contiguous()  # noqa: E731
    qq, kk, vv = q.transpose(0, 1)[None].contiguous(), rep(ks), rep(vs)
    r["library_ms"] = _median_ms(
        lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True), reps=5, batch=3)
    del qq, kk, vv
    flops = 4 * T * H * hd * (T + 1) / 2  # QK^T and PV over the causal keys
    r["bound_ms"], r["bound_by"] = _bound(_nbytes(q, ks, vs) + _nbytes(q), flops)
    p = A.prefill_plan(T, H // Hkv, Hkv, 0, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    r["plan"] = dict(ctas=p.n_ctas, segments=len(p.segs), merges=len(p.merges))
    print(f"  K1 T={T} visible_len=0 (recompute): kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f} ms), plain (row blocks) {r['plain_ms']:.4f} ms, sdpa causal "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); plan "
          f"{r['plan']}")
    del q, ks, vs, out
    torch.cuda.empty_cache()
    return r


def _sdpa_lanes_ms(q, ks, vs, mask):
    """F.scaled_dot_product_attention's time over B lanes at once: q [B, T,
    H, hd], keys/values [B, S, Hkv, hd] (kv heads repeated per query head),
    mask [B, T, S], laid out outside the timed call."""
    import torch.nn.functional as F

    H, Hkv = q.shape[2], ks.shape[2]
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()  # noqa: E731
    qq, kk, vv, mm = q.transpose(1, 2).contiguous(), rep(ks), rep(vs), mask[:, None]
    return _median_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm))


def _phase_lanes(g) -> dict:
    """The lane forms of K3, K2 and K1 (one launch for B streams, lanes of a
    [B, 2, C, Hkv, hd] arena's layer, per-lane lengths) against their plain
    lane versions, at the tolerances of the one-lane checks: K3 (both
    storage forms) and K2 at LANE_VISIBLE, K1 at K1_LANE_INSERT_AT in both
    modes. K3 runs before K2 (they share the scratch's counters). Then the
    lane forms' times at the multi-stream slices' shapes, beside their
    bounds, plain versions and SDPA over the B lanes."""
    import torch

    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    H, Hkv, hd, C, e_delta, Bmax = 28, 4, 128, 10240, 20, 8
    kw = dict(e_delta=e_delta, mrope_section=(16, 24, 24), rope_theta=1e6)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    ka, va = rn(Bmax, 2, C, Hkv, hd)[:, 1], rn(Bmax, 2, C, Hkv, hd)[:, 1]  # lane-strided layers
    (kq, ksc), (vq, vsc) = quantize_kv(ka), quantize_kv(va)
    pos = (torch.rand(Bmax, C, 3, generator=g, device=dev)
           * torch.tensor([C, 50.0, 50.0], device=dev)).floor()
    q, ksm, vsm = rn(Bmax, H, hd), rn(Bmax, e_delta + 1, Hkv, hd), rn(Bmax, e_delta + 1, Hkv, hd)
    forms = {"int8": lambda B: (kq[:B], ksc[:B], vq[:B], vsc[:B]),
             "bf16": lambda B: (ka[:B], None, va[:B], None)}
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for name in ("K3", "K2"):
        for B, sets in LANE_VISIBLE.items():
            for lens in sets:
                vis = torch.tensor(lens, dtype=torch.int32, device=dev)
                for evis in (0, 7, 20):
                    for form in (("int8", "bf16") if name == "K3" else ("bf16",)):
                        if name == "K3":
                            a = (q[:B], *forms[form](B), pos[:B], ksm[:B], vsm[:B])
                            got = A.streaming_decode_attention_int8(
                                *a, vis, evis, max_visible=max(lens), **kw)
                            want = A.decode_attention_int8_lanes_plain(*a, lens, evis, **kw)
                        else:
                            a = (q[:B], ka[:B], va[:B], ksm[:B], vsm[:B])
                            got = A.streaming_decode_attention_full(
                                *a, vis, evis, e_delta=e_delta, max_visible=max(lens))
                            want = A.decode_attention_lanes_plain(*a, lens, evis, e_delta=e_delta)
                        err[name] = max(err[name], _check_decode(name, got, want, dict(
                            lanes=B, form=form, visible_len=list(lens), extra_visible=evis)))
    B1, T = len(K1_LANE_INSERT_AT), 640
    q1, ks1, vs1 = rn(B1, T, H, hd), rn(B1, T, Hkv, hd), rn(B1, T, Hkv, hd)
    ang = torch.randn(B1, C, hd // 2, generator=g, device=dev)
    cs2 = (torch.cat([ang.cos()] * 2, -1).contiguous(), torch.cat([ang.sin()] * 2, -1).contiguous())
    ins = list(K1_LANE_INSERT_AT)
    for mode, cs in (("prerotated", (None, None)), ("raw", cs2)):
        a = (q1, ka[:B1], va[:B1], *cs, ks1, vs1, ins)
        err["K1"] = max(err["K1"], _check_k1(A.streaming_prefill_attention(*a),
                                             A.prefill_attention_lanes_plain(*a),
                                             dict(lanes=B1, T=T, visible_len=ins, mode=mode)))
    out = {"streaming_prefill_attention": {"max_abs_err": err["K1"]},
           "streaming_decode_attention_full": {"max_abs_err": err["K2"]},
           "streaming_decode_attention_int8": {"max_abs_err": err["K3"]}}
    if not _TIMED:
        return out

    # K1 at slice D's round: 6 lanes of 640 queries, each over 9600 visible slots
    vis = [C - T] * B1
    a = (q1, ka[:B1], va[:B1], None, None, ks1, vs1, vis)
    k1 = dict(lanes=B1, T=T, visible_len=vis[0],
              ms=_median_ms(lambda: A.streaming_prefill_attention(*a)),
              device_ms=_device_ms(lambda: A.streaming_prefill_attention(*a)),
              plain_ms=_median_ms(lambda: A.prefill_attention_lanes_plain(*a), reps=3, batch=2),
              ragged_device_ms=_device_ms(lambda: A.streaming_prefill_attention(
                  q1, ka[:B1], va[:B1], None, None, ks1, vs1, ins)))
    mask = torch.cat([torch.ones(T, vis[0], dtype=torch.bool, device=dev),
                      torch.ones(T, T, dtype=torch.bool, device=dev).tril()], 1)
    k1["library_ms"] = _sdpa_lanes_ms(q1, torch.cat([ka[:B1, : vis[0]], ks1], 1),
                                      torch.cat([va[:B1, : vis[0]], vs1], 1),
                                      mask.expand(B1, T, -1))
    flops = B1 * 4 * T * H * hd * (vis[0] + (T + 1) / 2)
    k1["bound_ms"], k1["bound_by"] = _bound(
        2 * _nbytes(q1) + B1 * _nbytes(ka[0, : vis[0]], va[0, : vis[0]]) + _nbytes(ks1, vs1), flops)
    out["streaming_prefill_attention"].update(k1)
    print(f"  K1 lanes={B1} T={T} visible_len={vis[0]}: kernel {k1['ms']:.4f} ms (device "
          f"{k1['device_ms']:.4f} ms; ragged {ins}: {k1['ragged_device_ms']:.4f}), plain "
          f"{k1['plain_ms']:.4f} ms, sdpa {k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']})")

    # K2 at slices D and E (6 and 8 lanes), K3 at slice F (4 lanes, int8),
    # every lane at visible 9000, extra_visible 7
    v9, evis = 9000, 7
    col = torch.arange(e_delta + 1, device=dev)
    small_mask = (col < evis) | (col >= e_delta)
    for name, B in (("streaming_decode_attention_full", 6), ("streaming_decode_attention_full", 8),
                    ("streaming_decode_attention_int8", 4)):
        vis = torch.full((B,), v9, dtype=torch.int32, device=dev)
        if name.endswith("full"):
            a = (q[:B], ka[:B], va[:B], ksm[:B], vsm[:B])
            f = lambda: A.streaming_decode_attention_full(  # noqa: E731
                *a, vis, evis, e_delta=e_delta, max_visible=v9)
            plain = lambda: A.decode_attention_lanes_plain(*a, v9, evis, e_delta=e_delta)  # noqa: E731
            nbytes = 2 * _nbytes(q[:B]) + B * _nbytes(ka[0, :v9], va[0, :v9]) + _nbytes(
                ksm[:B], vsm[:B])
            r = dict(ms=_median_ms(f), device_ms=_device_ms(f), plain_ms=_median_ms(plain))
            mask = torch.cat([torch.ones(v9, dtype=torch.bool, device=dev), small_mask])
            r["library_ms"] = _sdpa_lanes_ms(
                q[:B, None], torch.cat([ka[:B, :v9], ksm[:B]], 1), torch.cat([va[:B, :v9], vsm[:B]], 1),
                mask.expand(B, 1, -1))
            r["bound_ms"], r["bound_by"] = _bound(nbytes, B * 4 * H * hd * (v9 + e_delta + 1))
        else:
            a = (q[:B], *forms["int8"](B), pos[:B], ksm[:B], vsm[:B])
            f = lambda: A.streaming_decode_attention_int8(  # noqa: E731
                *a, vis, evis, max_visible=v9, **kw)
            plain = lambda: A.decode_attention_int8_lanes_plain(*a, v9, evis, **kw)  # noqa: E731
            nbytes = 2 * _nbytes(q[:B]) + B * _nbytes(kq[0, :v9], ksc[0, :v9], vq[0, :v9],
                                                      vsc[0, :v9], pos[0, :v9]) + _nbytes(
                ksm[:B], vsm[:B])
            r = dict(ms=_median_ms(f), device_ms=_device_ms(f), plain_ms=_median_ms(plain),
                     library_ms=None)
            r["bound_ms"], r["bound_by"] = _bound(
                nbytes, B * (2 * H * hd * v9 + 4 * H * hd * (e_delta + 1)),
                f32_ops=B * Hkv * v9 * (K3_F32_OPS_PER_ROW + 2 * (H // Hkv) * hd))
        lens = LANE_VISIBLE[8][0][:B]
        vis_r = torch.tensor(lens, dtype=torch.int32, device=dev)
        r["ragged_visible_len"] = list(lens)
        if name.endswith("full"):
            r["ragged_device_ms"] = _device_ms(lambda: A.streaming_decode_attention_full(
                q[:B], ka[:B], va[:B], ksm[:B], vsm[:B], vis_r, evis, e_delta=e_delta,
                max_visible=max(lens)))
        else:
            r["ragged_device_ms"] = _device_ms(lambda: A.streaming_decode_attention_int8(
                q[:B], *forms["int8"](B), pos[:B], ksm[:B], vsm[:B], vis_r, evis,
                max_visible=max(lens), **kw))
        r["split"] = A.decode_split_size(v9, Hkv, A.sm_count(torch.device(dev)), 160, B)
        out[name][f"lanes={B}"] = dict(lanes=B, visible_len=v9, extra_visible=evis, **r)
        lib = f"sdpa {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "no library call"
        print(f"  {'K2' if name.endswith('full') else 'K3 int8'} lanes={B} visible_len={v9}: kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, split {r['split']}; ragged "
              f"{list(lens)}: {r['ragged_device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


# the evaluation harnesses' K1 shapes (phase 3): MCQ's batch as lanes at
# visible 0 (B right-padded questions, the bucket T, each lane's real length
# below it), VQA's prefill over a fresh raw arena of C_VQA slots at visible 0
# (T_VQA, slice N's 8-frame prompt bucket) and its T = 1 steps over that
# arena at visible VQA_STEPS
MCQ_LANES, MCQ_T = 8, 1024
MCQ_REAL = (200, 333, 512, 640, 768, 900, 1000, 1024)
T_VQA, C_VQA = 1024, 2048
VQA_STEPS = (700, 777, 1000)


def _phase_k1_eval(g) -> dict:
    """K1 at the shapes the evaluation harnesses give it, against its plain
    version at phase 3's tolerance: the MCQ batch (MCQ_LANES lanes of MCQ_T
    rows at visible 0, pre-rotated mode, the self block standing in for the
    arena as `language_forward_lanes(arena=None)` passes it; rows past a
    lane's real length repeat one pad row), VQA's raw-mode prefill at
    visible 0 and its raw-mode T = 1 steps. Device times beside SDPA's for the same work and the bound."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    H, Hkv, hd = 28, 4, 128

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    B, T = MCQ_LANES, MCQ_T
    # rows past a lane's real length hold one pad row each (the pad token's
    # q, k and v at every pad position), as a right-padded batch has them
    q, ks, vs = rn(B, T, H, hd), rn(B, T, Hkv, hd), rn(B, T, Hkv, hd)
    pad = (torch.arange(T, device=dev)[None, :] >= torch.tensor(MCQ_REAL, device=dev)[:, None])
    q, ks, vs = (torch.where(pad[..., None, None], x[:, -1:], x).contiguous() for x in (q, ks, vs))
    mcq = (q, ks, vs, None, None, ks, vs, [0] * B)
    err = _check_k1(A.streaming_prefill_attention(*mcq), A.prefill_attention_lanes_plain(*mcq),
                    dict(lanes=B, T=T, visible_len=0, mode="prerotated", real=list(MCQ_REAL)))
    r = {"mcq": dict(lanes=B, T=T, visible_len=0)}
    if _TIMED:
        f = lambda: A.streaming_prefill_attention(*mcq)  # noqa: E731
        qq, kk, vv = (x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2).contiguous()
                      for x in (q, ks, vs))
        flops = B * 4 * T * H * hd * (T + 1) / 2
        r["mcq"].update(device_ms=_device_ms(f), plain_ms=_median_ms(
            lambda: A.prefill_attention_lanes_plain(*mcq), reps=3, batch=2),
            library_ms=_median_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                                         is_causal=True)))
        r["mcq"]["bound_ms"], r["mcq"]["bound_by"] = _bound(2 * _nbytes(q) + _nbytes(ks, vs),
                                                            flops)
        del qq, kk, vv

    # VQA: a fresh raw arena (K un-rotated, rotated in the kernel from the
    # slots' positions), its first T_VQA slots the prompt's block
    ka, va = rn(C_VQA, Hkv, hd), rn(C_VQA, Hkv, hd)
    ang = torch.randn(C_VQA, hd // 2, generator=g, device=dev)
    cs = (torch.cat([ang.cos()] * 2, -1).contiguous(), torch.cat([ang.sin()] * 2, -1).contiguous())
    qp, kp, vp = rn(T_VQA, H, hd), rn(T_VQA, Hkv, hd), rn(T_VQA, Hkv, hd)
    pre = (qp, ka, va, *cs, kp, vp, 0)
    err = max(err, _check_k1(A.streaming_prefill_attention(*pre), A.prefill_attention_plain(*pre),
                             dict(T=T_VQA, visible_len=0, mode="raw", C=C_VQA)))
    q1, k1, v1 = rn(1, H, hd), rn(1, Hkv, hd), rn(1, Hkv, hd)
    for vis in VQA_STEPS:
        step = (q1, ka, va, *cs, k1, v1, vis)
        err = max(err, _check_k1(A.streaming_prefill_attention(*step),
                                 A.prefill_attention_plain(*step),
                                 dict(T=1, visible_len=vis, mode="raw", C=C_VQA)))
    r["vqa_prefill"] = dict(T=T_VQA, visible_len=0, C=C_VQA)
    r["vqa_step"] = dict(T=1, visible_len=VQA_STEPS[-1], C=C_VQA)
    if _TIMED:
        rep = lambda x: x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None].contiguous()  # noqa: E731
        qq, kk, vv = qp.transpose(0, 1)[None].contiguous(), rep(kp), rep(vp)
        f = lambda: A.streaming_prefill_attention(*pre)  # noqa: E731
        r["vqa_prefill"].update(
            device_ms=_device_ms(f), plain_ms=_median_ms(lambda: A.prefill_attention_plain(*pre)),
            library_ms=_median_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                                         is_causal=True)))
        r["vqa_prefill"]["bound_ms"], r["vqa_prefill"]["bound_by"] = _bound(
            2 * _nbytes(qp) + _nbytes(kp, vp), 4 * T_VQA * H * hd * (T_VQA + 1) / 2)
        vis = VQA_STEPS[-1]
        step = (q1, ka, va, *cs, k1, v1, vis)
        f = lambda: A.streaming_prefill_attention(*step)  # noqa: E731
        # SDPA over the same keys, rotated outside its timed call
        kr = A._rotate_dup_half(ka[:vis], cs[0][:vis], cs[1][:vis]).to(torch.bfloat16)
        qs, kk, vv = q1.transpose(0, 1)[None].contiguous(), rep(torch.cat([kr, k1])), rep(
            torch.cat([va[:vis], v1]))
        r["vqa_step"].update(
            device_ms=_device_ms(f), plain_ms=_median_ms(lambda: A.prefill_attention_plain(*step)),
            library_ms=_median_ms(lambda: F.scaled_dot_product_attention(qs, kk, vv)))
        # K and V read once, positions' tables, q in and out
        r["vqa_step"]["bound_ms"], r["vqa_step"]["bound_by"] = _bound(
            _nbytes(ka[:vis], va[:vis], cs[0][:vis], cs[1][:vis], k1, v1) + 2 * _nbytes(q1),
            4 * H * hd * (vis + 1))
        for name, x in r.items():
            shape = {k: v for k, v in x.items() if not k.startswith(("device", "plain", "lib", "bound"))}
            print(f"  K1 {name} {shape}: "
                  f"device {x['device_ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, sdpa "
                  f"{x['library_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']})")
    r["max_abs_err"] = err
    return r


# K5 at the 7B path's shapes: (what, M, K, N, bias, f32 out). Text decode
# (M=1) and chunk prefill (M=640, the 640-token bucket), the vision tower
# at 2 frames of 476x840 (M=2040 patches) and its merger (M=510 tokens):
# qkv, proj and the merger are Qwen2.5-VL's and Qwen2-VL's; gate/up/down
# Qwen2.5-VL's SwiGLU, fc1/fc2 Qwen2-VL's MLP (slice G)
K5_SERVING = (
    ("decode q_proj", 1, 3584, 3584, True, False),
    ("decode k/v_proj", 1, 3584, 512, True, False),
    ("decode o_proj", 1, 3584, 3584, False, False),
    ("decode gate/up_proj", 1, 3584, 18944, False, False),
    ("decode down_proj", 1, 18944, 3584, False, False),
    ("lm_head", 1, 3584, 152064, False, True),
    ("prefill q_proj", 640, 3584, 3584, True, False),
    ("prefill k/v_proj", 640, 3584, 512, True, False),
    ("prefill o_proj", 640, 3584, 3584, False, False),
    ("prefill gate/up_proj", 640, 3584, 18944, False, False),
    ("prefill down_proj", 640, 18944, 3584, False, False),
    ("vision qkv", 2040, 1280, 3840, True, False),
    ("vision proj", 2040, 1280, 1280, True, False),
    ("vision gate/up_proj", 2040, 1280, 3420, True, False),
    ("vision down_proj", 2040, 3420, 1280, True, False),
    ("qwen2 vision fc1", 2040, 1280, 5120, True, False),
    ("qwen2 vision fc2", 2040, 5120, 1280, True, False),
    ("merger fc1", 510, 5120, 5120, True, False),
    ("merger fc2", 510, 5120, 3584, True, False),
    # the multi-stream slices: decode at M = B lanes (the tiled path above
    # SMALL_M), the round's prefill at M = B * 640
    ("decode (6 lanes) gate/up_proj", 6, 3584, 18944, False, False),
    ("decode (8 lanes) gate/up_proj", 8, 3584, 18944, False, False),
    ("lm_head (8 lanes)", 8, 3584, 152064, False, True),
    ("prefill (6 lanes) gate/up_proj", 3840, 3584, 18944, False, False),
    ("prefill (8 lanes) q_proj", 5120, 3584, 3584, True, False),
)
# the int32 form: the TPU probe's shape, then the ragged edges
K5_INT32 = ((4096, 4096, 4096), (2040, 3420, 1280), (2040, 1280, 3420), (1, 3584, 152064),
            (1, 3420, 1280), (3, 3584, 512))
K5_TIMED = ("decode gate/up_proj", "lm_head", "prefill gate/up_proj",
            "decode (6 lanes) gate/up_proj", "decode (8 lanes) gate/up_proj",
            "prefill (6 lanes) gate/up_proj", "vision qkv", "vision proj", "qwen2 vision fc1",
            "qwen2 vision fc2", "merger fc1", "merger fc2")
K5_QWEN2_VISION = ("vision qkv", "vision proj", "qwen2 vision fc1", "qwen2 vision fc2",
                   "merger fc1", "merger fc2")


def _phase_k5(g) -> dict:
    """K5 against its plain version, bitwise: the int32 form (K5_INT32) and
    the serving form (K5_SERVING, with an all-zero and an outlier row where
    M > 2). Times at K5_TIMED and the probe, beside the bound (bytes at the
    HBM rate or operations at the int8 peak) and torch._int_mm (cuBLASLt
    int8, timed only) where it takes the shape."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import quant as Q

    dev = "cuda"

    def rint8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    err = 0.0
    for M, K, N in K5_INT32:
        xq, wq = rint8(M, K), rint8(N, K)
        err = max(err, _check_equal("K5", Q.int8_gemm(xq, wq), Q.int8_gemm_plain(xq, wq),
                                    dict(form="int32", M=M, K=K, N=N)))
    inputs = {}
    for what, M, K, N, bias, f32 in K5_SERVING:
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        if M > 2:
            x[0] = 0
            x[1, 11] = 300.0
        q = Q.pad_rows(rint8(N, K))  # as QLinear holds it: rows padded to 16 bytes
        s = torch.rand(N, generator=g, device=dev) * 1e-3 + 1e-5
        b = torch.randn(N, generator=g, device=dev).to(torch.bfloat16) if bias else None
        od = torch.float32 if f32 else torch.bfloat16
        args = (x, q, s, b, od)
        err = max(err, _check_equal("K5", Q.qdot(*args), Q.qdot_plain(*args), dict(
            form="f32 out" if f32 else "bf16 out", what=what, M=M, K=K, N=N, bias=bias)))
        if what in K5_TIMED:
            inputs[what] = args
        del x, q, s, b
    torch.cuda.synchronize()

    by_shape = {}
    for what, (x, q, s, b, od) in inputs.items():
        (M, K), N = x.shape, q.shape[0]
        r = dict(M=M, K=K, N=N, ms=_median_ms(lambda: Q.qdot(x, q, s, b, od)),
                 device_ms=_device_ms(lambda: Q.qdot(x, q, s, b, od)),
                 plain_ms=_median_ms(lambda: Q.qdot_plain(x, q, s, b, od)))
        if M == 1:  # the decode GEMV with cold weights, as K5-int4's are timed
            r["device_ms_cold"] = _cold_device_ms(lambda qq, ss: Q.qdot(x, qq, ss, b, od), (q, s))
        out_bytes = M * N * (4 if od == torch.float32 else 2)
        r["bound_ms"], r["bound_by"] = _bound(_nbytes(x, q, s, b) + out_bytes, 2 * M * N * K,
                                              INT8_OPS)
        if M > 16:
            xq, _ = Q.quantize_rows(x)
            wt = q.t()
            r["library_ms"] = _median_ms(lambda: torch._int_mm(xq, wt))
            r["library"] = "torch._int_mm (cuBLASLt, int8 -> int32: the product alone)"
        else:
            wb = q.to(torch.bfloat16)
            r["library_ms"] = None
            r["library"] = f"torch._int_mm refuses M={M} (it takes M > 16)"
            r["bf16_linear_ms"] = _median_ms(lambda: F.linear(x, wb))  # another function
            del wb
        by_shape[what] = r
        print(f"  K5 {what} M={M} K={K} N={N}: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms" + (f", cold {r['device_ms_cold']:.4f} ms"
                                            if "device_ms_cold" in r else "") + "), plain "
              f"{r['plain_ms']:.4f} ms, library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else
                 f"none ({r['library']}; bf16 F.linear, another function, "
                 f"{r['bf16_linear_ms']:.4f} ms)")
              + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    inputs.clear()

    # the int32 form (the product alone, no row quantization or epilogue)
    # at every tiled shape of the path, beside torch._int_mm where it takes
    # the shape (K and N multiples of 8), operands laid out as served (rows
    # padded to 16 bytes)
    int32 = {}
    for what, M, K, N, _, _ in K5_SERVING:
        if M <= 4 or (M, K, N) in {(r["M"], r["K"], r["N"]) for r in int32.values()}:
            continue
        xq, wq = Q.pad_rows(rint8(M, K)), Q.pad_rows(rint8(N, K))
        plan = Q.gemm_plan(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
        r = dict(M=M, K=K, N=N, tile_n=plan.bn, ctas=plan.n_ctas, split_tiles=len(plan.fixups),
                 device_ms=_device_ms(lambda: Q.int8_gemm(xq, wq)))
        r["bound_ms"], r["bound_by"] = _bound(M * K + N * K + 4 * M * N, 2 * M * N * K, INT8_OPS)
        if K % 8 == 0 and N % 8 == 0 and M > 16:
            wt = wq.t()
            r["library_ms"] = _median_ms(lambda: torch._int_mm(xq, wt))
            r["library_device_ms"] = _device_ms(lambda: torch._int_mm(xq, wt))
        else:
            r["library_ms"] = r["library_device_ms"] = None
        int32[what] = r
        print(f"  K5 int32 form {what} M={M} K={K} N={N}: kernel device {r['device_ms']:.4f} ms "
              f"(tile 128x{plan.bn}, {plan.n_ctas} CTAs, {len(plan.fixups)} split tiles), "
              + (f"torch._int_mm {r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})"
                 if r["library_ms"] is not None else
                 "torch._int_mm refuses M <= 16, or K or N % 8 != 0")
              + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        del xq, wq

    n = 4096
    xq, wq = rint8(n, n), rint8(n, n)
    wt = wq.t()
    probe = dict(M=n, K=n, N=n, ms=_median_ms(lambda: Q.int8_gemm(xq, wq)),
                 device_ms=_device_ms(lambda: Q.int8_gemm(xq, wq)),
                 library_ms=_median_ms(lambda: torch._int_mm(xq, wt)),
                 library_device_ms=_device_ms(lambda: torch._int_mm(xq, wt)))
    # device time on the card (CUDA-event time where the trace has none)
    probe["tops"] = 2 * n**3 / ((probe["device_ms"] or probe["ms"]) * 1e-3) / 1e12
    probe["library_tops"] = 2 * n**3 / (
        (probe["library_device_ms"] or probe["library_ms"]) * 1e-3) / 1e12
    print(f"  K5 probe int32 form {n}^3: kernel {probe['ms']:.4f} ms (device {probe['device_ms']:.4f} "
          f"ms = {probe['tops']:.1f} TOP/s of {INT8_OPS / 1e12:.0f}); torch._int_mm "
          f"{probe['library_ms']:.4f} ms (device {probe['library_device_ms']:.4f} ms = "
          f"{probe['library_tops']:.1f} TOP/s)")
    keys = ("M", "K", "N", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library")
    gemv, tiled = by_shape["decode gate/up_proj"], by_shape["prefill gate/up_proj"]
    lanes = {w: by_shape[w] for w in K5_TIMED if "lanes" in w}
    qwen2_vision = {w: by_shape[w] for w in K5_QWEN2_VISION}
    return {
        "gemv": dict(max_abs_err=err, shape="decode gate/up_proj (M=1, K=3584, N=18944)",
                     bf16_linear_ms=gemv["bf16_linear_ms"], device_ms_cold=gemv["device_ms_cold"],
                     **{k: gemv[k] for k in keys},
                     lm_head=by_shape["lm_head"]),
        "tiled": dict(max_abs_err=err, shape="prefill gate/up_proj (M=640, K=3584, N=18944), "
                      "serving form (row quantization + product + epilogue)",
                      **{k: tiled[k] for k in keys}, int32_form=int32, probe=probe,
                      lanes=lanes, qwen2_vision=qwen2_vision),
    }


# K5-int4 (W4A8's qdot4 below 32 rows): every decode product of the 7B
# path (what, K, N, bias), at each of K5_INT4_ROWS rows (1: one stream; 4,
# 8: lanes; 31: qdot4's threshold, where K = 18944 is cut into slabs), bf16
# and f32 out; 3592 and 3616 are K % 128 != 0 (one scale group; 3592's
# packed rows are not 16-byte multiples). K5_INT4_SPLIT: the same checks
# with K cut into slabs by force (per-group records folded by a tile's last
# part), at the narrow and long-K products. Timed at K5_INT4_TIMED_ROWS for
# the decode products and at M = 1 for the lm_head, warm and cold.
K5_INT4 = (
    ("decode q_proj", 3584, 3584, True),
    ("decode k/v_proj", 3584, 512, True),
    ("decode o_proj", 3584, 3584, False),
    ("decode gate/up_proj", 3584, 18944, False),
    ("decode down_proj", 18944, 3584, False),
    ("one group, 4-byte rows", 3592, 3584, True),
    ("one group, 16-byte rows", 3616, 3584, False),
)
K5_INT4_ROWS = (1, 4, 8, 31)
K5_INT4_SPLIT = {"decode k/v_proj": (2, 4), "decode q_proj": (2,), "decode down_proj": (2, 37)}
K5_INT4_SPLIT_ROWS = (1, 8)
K5_INT4_TIMED = ("decode q_proj", "decode k/v_proj", "decode o_proj", "decode gate/up_proj",
                 "decode down_proj", "lm_head")
K5_INT4_TIMED_ROWS = (1, 4, 8)
# cold weights: a timed call rotates over copies of its weight whose bytes
# exceed twice the H100's 50 MB L2, as a decode step walks 28 layers of
# weights and finds each cold
COLD_BYTES = 2 * 50 * 2**20


def _cold_device_ms(call, weights) -> float:
    """Device time of one call(*w) with cold weights: the calls rotate over
    copies of `weights` (tensors) whose bytes exceed COLD_BYTES (the
    weights themselves when they alone do)."""
    import torch

    nbytes = _nbytes(*weights)
    copies = [weights] + [tuple(w.clone() for w in weights)
                          for _ in range(-(-COLD_BYTES // nbytes) - 1)]
    i = [0]

    def rotate():
        call(*copies[i[0] % len(copies)])
        i[0] += 1

    ms = _device_ms(rotate, n=max(20, 2 * len(copies)))
    del copies
    torch.cuda.empty_cache()
    return ms


def _phase_k5_int4(g) -> dict:
    """K5-int4 against qdot4_plain, bitwise: K5_INT4 at K5_INT4_ROWS, bf16
    and f32 out (bias where the product has one), all-zero and outlier rows
    where M > 2, the lm_head (f32 out) at the same rows, and K5_INT4_SPLIT's
    forced slabs. Random packed weights (every nibble value) and group
    scales. Device times warm (one weight, back to back) and cold (rotated
    copies) at every decode product and M in K5_INT4_TIMED_ROWS and at the
    lm_head, beside the bound (the packed weight, its scales, x and the
    output at the HBM rate); at M = 1 also the CUDA-event time, the plain
    version's and bf16 F.linear over the dequantized weight (another
    function: no single PyTorch call computes qdot4)."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import quant as Q

    dev = "cuda"
    err, weights = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, K, N, bias in K5_INT4 + (("lm_head", 3584, 152064, False),):
        q4 = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev,
                           dtype=torch.int16).to(torch.int8)
        s = torch.rand(N, Q.int4_groups(K), generator=g, device=dev) * 1e-2 + 1e-4
        for M in K5_INT4_ROWS:
            x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            if M > 2:
                x[0] = 0
                x[1, 11] = 300.0
            forced = K5_INT4_SPLIT.get(what, ()) if M in K5_INT4_SPLIT_ROWS else ()
            for slabs in (None,) + forced:
                plan = Q.int4_plan(M, N, K, sms, slabs)
                for od in ((torch.float32,) if what == "lm_head" else
                           (torch.bfloat16, torch.float32)):
                    b = torch.randn(N, generator=g, device=dev).to(od) if bias else None
                    got = Q._qdot4_with_plan(x, q4, s, b, od, slabs)
                    err = max(err, _check_equal("K5-int4", got, Q.qdot4_plain(x, q4, s, b, od),
                                                dict(what=what, M=M, K=K, N=N,
                                                     ng=Q.int4_groups(K), bias=bias,
                                                     out="f32" if od == torch.float32 else "bf16",
                                                     **({"slabs": plan.slabs} if plan.slabs > 1
                                                        else {}))))
        if what in K5_INT4_TIMED:
            weights[what] = (q4, s, bias)
        else:
            del q4, s
    torch.cuda.synchronize()
    if not _TIMED:
        return dict(max_abs_err=err)
    by_shape = {}
    for what, (q4, s, bias) in weights.items():
        N, K = q4.shape[0], 2 * q4.shape[1]
        od = torch.float32 if what == "lm_head" else torch.bfloat16
        b = torch.randn(N, generator=g, device=dev).to(od) if bias else None
        r = {}
        for M in ((1,) if what == "lm_head" else K5_INT4_TIMED_ROWS):
            x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            f = lambda: Q.qdot4(x, q4, s, b, od)  # noqa: E731
            bound, by = _bound(_nbytes(x, q4, s, b) + M * N * (4 if od == torch.float32 else 2),
                               2 * M * N * K, INT8_OPS)
            rm = dict(M=M, K=K, N=N, plan=Q.int4_plan(M, N, K, sms)._asdict(),
                      device_ms=_device_ms(f),
                      device_ms_cold=_cold_device_ms(lambda q, sc: Q.qdot4(x, q, sc, b, od),
                                                     (q4, s)),
                      bound_ms=bound, bound_by=by)
            if M == 1:
                rm.update(ms=_median_ms(f), plain_ms=_median_ms(
                    lambda: Q.qdot4_plain(x, q4, s, b, od), reps=3, batch=2))
                wb = Q.dequantize_int4(q4, s)
                rm.update(library_ms=None, library="none: no single PyTorch call",
                          bf16_linear_ms=_median_ms(lambda: F.linear(x, wb)))  # another function
                del wb
                r.update(rm)
            else:
                r[f"M{M}"] = rm
            print(f"  K5-int4 {what} M={M} K={K} N={N}: device {rm['device_ms']:.4f} ms warm, "
                  f"{rm['device_ms_cold']:.4f} ms cold; bound {bound:.4f} ms ({by}), cold share "
                  f"{bound / rm['device_ms_cold']:.2f}" if rm["device_ms_cold"] else "")
            if M == 1:
                print(f"    event {rm['ms']:.4f} ms, plain {rm['plain_ms']:.4f} ms, library none "
                      f"(no single PyTorch call; bf16 F.linear over the dequantized weight, "
                      f"another function, {rm['bf16_linear_ms']:.4f} ms)")
        by_shape[what] = r
    weights.clear()
    torch.cuda.empty_cache()
    main = by_shape.get("decode gate/up_proj", {})
    keys = ("M", "K", "N", "ms", "device_ms", "device_ms_cold", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library", "bf16_linear_ms")
    return dict(max_abs_err=err, shape="decode gate/up_proj (M=1, K=3584, N=18944), bf16 out",
                **{k: main.get(k) for k in keys}, by_shape=by_shape)


@contextlib.contextmanager
def _plain_k5():
    """Bind K5's plain version where QLinear calls it (phase 4's noise
    floor; the serving path has no such route)."""
    from streaming_vlm_tpu_torch.ops import quant as Q

    kernel = Q.qdot
    Q.qdot = Q.qdot_plain
    try:
        yield
    finally:
        Q.qdot = kernel


@contextlib.contextmanager
def _plain_qdot4():
    """Bind qdot4's plain version where QLinear4 calls it (phase 4's noise
    floor; the serving path has no such route)."""
    from streaming_vlm_tpu_torch.ops import quant as Q

    kernel = Q.qdot4
    Q.qdot4 = Q.qdot4_plain
    try:
        yield
    finally:
        Q.qdot4 = kernel


@contextlib.contextmanager
def _plain_raw_decode():
    """Bind K3's plain version where the decoder calls K3 (phase 4's noise
    floor; the serving path has no such route)."""
    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.ops import attention as A

    kernel = lang.streaming_decode_attention_int8
    lang.streaming_decode_attention_int8 = A.decode_attention_int8_lanes_plain
    try:
        yield
    finally:
        lang.streaming_decode_attention_int8 = kernel


def phase_reference(cfg, cases: str = "abcd"):
    """At 7B width with the decoder cut to REF_LAYERS layers: the streaming
    forward through the kernels in bf16 against the plain full-attention
    oracle in f32 on the same weights, (a) over the pre-rotated bf16 arena
    (K1 prefill, one K2 decode step; noise floor: the plain oracle in
    bf16), (b) over the int8 raw arena (K1 raw-mode prefill, the block
    quantized into the arena, one K3 decode step; noise floor: the same
    decode step with K3's plain version over the same quantized arena), (c)
    with the weights quantized to W8A8, over the int8 arena with its
    pre-rotated K copy (K5 for every product, K1, K2), against the oracle
    on the dequantized weights (noise floor: the same forward with K5's
    plain version), (d) with the weights quantized to W4A8 (the int4
    decoder, prefill through qdot4's bf16 product, the decode step through
    K5-int4) over the same arena, against the oracle on the dequantized
    int4 weights (noise floor: qdot4's plain version). `cases` picks among
    (a) to (d)."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.ops import quant as Q
    from streaming_vlm_tpu_torch.ops.quant import (
        LAYER_LINEARS,
        QuantKV,
        dequantize_int4,
        quantize_kv,
        quantize_language,
        write_slots,
    )

    tcfg = dataclasses.replace(cfg.text, num_hidden_layers=REF_LAYERS)
    rcfg = dataclasses.replace(cfg, text=tcfg)
    lm = init_params(rcfg, torch.Generator(device="cuda").manual_seed(1),
                     device="cuda", dtype=torch.bfloat16).text
    lm32 = copy.deepcopy(lm).float()
    dev = lm.embed.weight.device
    T, C, E = 64, 512, 4
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, tcfg.vocab_size, T + 1)).to(dev)
    pos = torch.arange(T + 1, dtype=torch.float32, device=dev).expand(3, T + 1).contiguous()
    emb = lang.embed_tokens(tcfg, lm, ids)
    oracle32 = lang.lm_logits(tcfg, lm32, lang.language_forward(tcfg, lm32, emb.float(), pos))[-1]
    oracle16 = lang.lm_logits(tcfg, lm, lang.language_forward(tcfg, lm, emb, pos))[-1]
    scale = oracle32.abs().max()

    def rel(x):
        return float((x - oracle32).abs().max() / scale)

    L, Hkv, hd = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim
    dk = torch.zeros(L, E, Hkv, hd, dtype=torch.bfloat16, device=dev)
    delta = dict(extra=(dk, dk.clone()), extra_visible=0)
    errs = {}

    # (a) the pre-rotated bf16 arena: K1, then K2
    if "a" in cases:
        ka, va = lang.init_kv_arena(tcfg, C, torch.bfloat16, dev)
        _, (_, kbr, vb) = lang.language_forward_streaming(
            tcfg, lm, emb[:T], pos[:, :T], arena=(ka, va), arena_rotated=True, visible_len=0
        )
        ka[:, :T], va[:, :T] = kbr, vb  # the pre-rotated arena holds the prefix
        hidden, _ = lang.language_forward_streaming(
            tcfg, lm, emb[T:], pos[:, T:], arena=(ka, va), arena_rotated=True, visible_len=T,
            **delta
        )
        errs["bf16 pre-rotated (K1, K2)"] = (rel(lang.lm_logits(tcfg, lm, hidden)[0]),
                                             rel(oracle16))

    # (b) the int8 raw arena: K1 raw mode, quantize the block, then K3
    if "b" in cases:
        apos = torch.zeros(3, C, device=dev)
        apos[:, : T + 1] = pos
        kq, vq = lang.init_kv_arena(tcfg, C, torch.bfloat16, dev, quant="int8")
        _, (kb, _, vb) = lang.language_forward_streaming(
            tcfg, lm, emb[:T], pos[:, :T], arena=(kq, vq), arena_positions=apos, visible_len=0
        )
        for arena, block in ((kq, kb), (vq, vb)):
            qb = quantize_kv(block)
            arena.q[:, :T], arena.s[:, :T] = qb.q, qb.s
        assert isinstance(kq, QuantKV)
        raw = dict(arena=(kq, vq), arena_positions=apos, visible_len=T, **delta)
        h_k3, _ = lang.language_forward_streaming(tcfg, lm, emb[T:], pos[:, T:], **raw)
        with _plain_raw_decode():
            h_plain, _ = lang.language_forward_streaming(tcfg, lm, emb[T:], pos[:, T:], **raw)
        errs["int8 raw (K1 raw, K3)"] = (rel(lang.lm_logits(tcfg, lm, h_k3)[0]),
                                        rel(lang.lm_logits(tcfg, lm, h_plain)[0]))

    # (c) W8A8 weights over the int8 arena, pre-rotated (K5, K1, K2), against
    # the f32 oracle on the dequantized weights (q * s); noise floor: the
    # same forward with K5's plain version
    if "c" in cases:
        lmq = quantize_language(copy.deepcopy(lm))
        deq = lm32
        for layer, qlayer in zip(deq.layers, lmq.layers):
            for name in LAYER_LINEARS:
                ql = getattr(qlayer, name)
                getattr(layer, name).weight.copy_(ql.q.float() * ql.s[:, None])
        deq.lm_head.weight.copy_(lmq.lm_head.q.float() * lmq.lm_head.s[:, None])
        oracle_q = lang.lm_logits(tcfg, deq, lang.language_forward(tcfg, deq, emb.float(), pos))[-1]

        def w8a8_logits():
            kr = torch.zeros(L, C, Hkv, hd, dtype=torch.bfloat16, device=dev)  # rotated K copy
            _, vq8 = lang.init_kv_arena(tcfg, C, torch.bfloat16, dev, quant="int8")
            _, (_, kbr, vb) = lang.language_forward_streaming(
                tcfg, lmq, emb[:T], pos[:, :T], arena=(kr, vq8), arena_rotated=True, visible_len=0
            )
            kr[:, :T] = kbr
            write_slots(vq8, vb, 0)
            h, _ = lang.language_forward_streaming(
                tcfg, lmq, emb[T:], pos[:, T:], arena=(kr, vq8), arena_rotated=True, visible_len=T,
                **delta,
            )
            return lang.lm_logits(tcfg, lmq, h)[0]

        def rel_q(x):
            return float((x - oracle_q).abs().max() / oracle_q.abs().max())

        got = w8a8_logits()
        with _plain_k5():
            floor = w8a8_logits()
        errs["W8A8, int8 pre-rotated (K5, K1, K2)"] = (rel_q(got), rel_q(floor))
        del lmq, deq

    # (d) W4A8 weights (int4 decoder products and lm_head) over the int8
    # arena, pre-rotated: the prefill's products take qdot4's bf16 path, the
    # decode step's K5-int4; against the f32 oracle on the dequantized int4
    # weights (noise floor: the same forward with qdot4's plain version)
    if "d" in cases:
        lm4 = quantize_language(copy.deepcopy(lm), bits=4)
        deq = copy.deepcopy(lm).float()
        for layer, qlayer in zip(deq.layers, lm4.layers):
            for name in LAYER_LINEARS:
                ql = getattr(qlayer, name)
                getattr(layer, name).weight.copy_(dequantize_int4(ql.q4, ql.s, torch.float32))
        deq.lm_head.weight.copy_(dequantize_int4(lm4.lm_head.q4, lm4.lm_head.s, torch.float32))
        oracle_4 = lang.lm_logits(tcfg, deq, lang.language_forward(tcfg, deq, emb.float(), pos))[-1]

        def w4a8_logits():
            kr = torch.zeros(L, C, Hkv, hd, dtype=torch.bfloat16, device=dev)
            _, vq8 = lang.init_kv_arena(tcfg, C, torch.bfloat16, dev, quant="int8")
            _, (_, kbr, vb) = lang.language_forward_streaming(
                tcfg, lm4, emb[:T], pos[:, :T], arena=(kr, vq8), arena_rotated=True, visible_len=0
            )
            kr[:, :T] = kbr
            write_slots(vq8, vb, 0)
            h, _ = lang.language_forward_streaming(
                tcfg, lm4, emb[T:], pos[:, T:], arena=(kr, vq8), arena_rotated=True,
                visible_len=T, **delta,
            )
            return lang.lm_logits(tcfg, lm4, h)[0]

        def rel_4(x):
            return float((x - oracle_4).abs().max() / oracle_4.abs().max())

        n4 = Q.path_counts["int4"]
        got = w4a8_logits()
        launched = Q.path_counts["int4"] - n4
        with _plain_qdot4():
            floor = w4a8_logits()
        if launched != 7 * L + 1:
            raise AssertionError(f"W4A8 forward: {launched} K5-int4 launches, not {7 * L + 1}")
        errs["W4A8, int8 pre-rotated (K5-int4, K1, K2)"] = (rel_4(got), rel_4(floor))
        del lm4, deq
    torch.cuda.synchronize()
    for name, (err, floor) in errs.items():
        ok = math.isfinite(err) and err <= REF_NOISE_FACTOR * floor
        print(f"  {name}: last-token logits, {L} layers, T={T} prefill + 1 decode, "
              f"max|diff|/max|logit| vs the f32 oracle: kernels (bf16) {err:.3e}, plain bf16 "
              f"{floor:.3e} (bound {REF_NOISE_FACTOR} x plain) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"streaming forward ({name}) disagrees with the plain oracle")
    del lm, lm32
    torch.cuda.empty_cache()
    return errs


# phase 4's batched MCQ forward: 4 right-padded questions (their words, and
# the grid of the video crop each carries or None), one K1 lane-form launch a
# layer over the batch
MCQ_REF = (("Which team scores next?", (1, 34, 60)), ("Is the ball in play?", None),
           ("Who holds the ball at the end of this clip, and where on the pitch?", (2, 16, 28)),
           ("How many players are in the frame right now?", None))


def phase_mcq_reference(cfg) -> dict:
    """At 7B width with the decoder cut to REF_LAYERS layers (the tower
    whole): the batched MCQ forward (`eval.mcq`: the questions as lanes at
    visible 0, K1 once a layer) in bf16 against `forward_full` in f32 on
    the same weights, each question's last-row option logits, under phase
    4's noise rule (at most REF_NOISE_FACTOR times the error of
    `forward_full` in bf16, the plain path)."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.eval import mcq
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import forward_full, init_params
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.video.ingest import patchify_frames

    rcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             num_hidden_layers=REF_LAYERS))
    model = init_params(rcfg, torch.Generator(device="cuda").manual_seed(3), device="cuda",
                        dtype=torch.bfloat16)
    m32 = copy.deepcopy(model).float()
    tok = FakeTokenizer(cfg.tokens)
    v = cfg.vision
    rng = np.random.default_rng(9)
    opt = mcq.option_token_ids(tok, ["A", "B", "C", "D"])
    ids, vis, grids, spg, px = [], [], [], [], []
    for q, grid in MCQ_REF:
        n_vis = 0 if grid is None else int(np.prod(grid)) // v.spatial_merge_unit
        ids.append(mcq.build_mcq_prompt_ids(rcfg, tok, q, n_vis))
        if grid is None:
            vis.append(None), grids.append(None), spg.append(None), px.append(None)
            continue
        frames = rng.integers(0, 256, (grid[0] * v.temporal_patch_size, grid[1] * v.patch_size,
                                       grid[2] * v.patch_size, 3), dtype=np.uint8)
        patches, _ = patchify_frames(frames, patch_size=v.patch_size,
                                     temporal_patch_size=v.temporal_patch_size,
                                     merge_size=v.spatial_merge_size)
        px.append(torch.from_numpy(patches).cuda())
        grids.append(np.asarray([grid]))
        spg.append([1.0])
        vis.append(mcq._encode(rcfg, model, px[-1], grids[-1]))
    _reset_counts()
    got = mcq._mcq_scores(rcfg, model, ids, [opt] * len(ids), vis, grids, spg, bucket=128)
    torch.cuda.synchronize()
    counts = {k: c for k, c in _counts().items() if c}
    if counts != {"streaming_prefill_attention": REF_LAYERS}:
        raise AssertionError(f"batched MCQ forward: launches {counts}, not K1 {REF_LAYERS} times")
    worst, out = 0.0, {}
    for b in range(len(ids)):
        kw = dict(video_grid_thw=grids[b], second_per_grid_ts=spg[b])
        o32 = forward_full(rcfg, m32, ids[b], pixel_patches=None if px[b] is None else px[b],
                           **kw)[-1]
        o16 = forward_full(rcfg, model, ids[b], pixel_patches=None if px[b] is None
                           else px[b].to(torch.bfloat16), **kw)[-1]
        scale = float(o32.abs().max())
        err = float((got[b] - o32[opt]).abs().max()) / scale
        # the noise floor: the plain bf16 path's error over the whole row, as
        # phase 4's other cases take it (4 option logits alone can land near
        # f32 by chance)
        floor = float((o16 - o32).abs().max()) / scale
        ok = math.isfinite(err) and err <= REF_NOISE_FACTOR * floor
        print(f"  MCQ question {b} (len {len(ids[b])}, grid {MCQ_REF[b][1]}): option logits, "
              f"{REF_LAYERS} layers, max|diff|/max|logit| vs the f32 oracle: kernels (bf16) "
              f"{err:.3e}, plain bf16 {floor:.3e} (bound {REF_NOISE_FACTOR} x plain) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"batched MCQ forward (question {b}) disagrees with the oracle")
        worst = max(worst, err)
        out[f"q{b}"] = (err, floor)
    del model, m32
    torch.cuda.empty_cache()
    return dict(worst=worst, **out)


REF_VISION_BLOCKS = 4


def phase_vision_reference(cfg):
    """The vision tower at the config's widths, cut to REF_VISION_BLOCKS
    blocks, on one chunk: 2 synthetic 476x840 uint8 frames patchified on
    the card (grid (1, 34, 60), 2040 patches). The tower in bf16 (no
    kernel: plain attention and cuBLAS) and with W8A8 weights (K5 for every
    block and merger product) against the f32 tower on the same weights
    (the dequantized q * s for W8A8), as max |diff| / max |oracle|; the
    W8A8 tower may be at most REF_NOISE_FACTOR times as far from its oracle
    as the same tower with K5's plain version."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl import vision as V
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.ops.quant import QLinear, quantize_vision

    vcfg = dataclasses.replace(cfg.vision, depth=REF_VISION_BLOCKS)
    small = dataclasses.replace(cfg, vision=vcfg,
                                text=dataclasses.replace(cfg.text, num_hidden_layers=1))
    tower = init_params(small, torch.Generator(device="cuda").manual_seed(2), device="cuda",
                        dtype=torch.bfloat16).vision
    grid = (1, 34, 60)
    frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 476, 840, 3), dtype=np.uint8)).cuda()
    geo = tower.geometry([grid], frames.device)
    px16 = V.patchify_on_device(vcfg, frames, torch.bfloat16)
    px32 = V.patchify_on_device(vcfg, frames, torch.float32)
    oracle = V.vision_forward(vcfg, copy.deepcopy(tower).float(), px32, geo)

    def rel(x, ref):
        return float((x.float() - ref).abs().max() / ref.abs().max())

    err16 = rel(V.vision_forward(vcfg, tower, px16, geo), oracle)
    towerq = quantize_vision(copy.deepcopy(tower))
    deq = copy.deepcopy(tower).float()
    for (name, mod), (_, qmod) in zip(deq.named_modules(), towerq.named_modules()):
        if isinstance(qmod, QLinear):
            mod.weight.copy_(qmod.q.float() * qmod.s[:, None])
    oracle_q = V.vision_forward(vcfg, deq, px32, geo)
    got = rel(V.vision_forward(vcfg, towerq, px16, geo), oracle_q)
    with _plain_k5():
        floor = rel(V.vision_forward(vcfg, towerq, px16, geo), oracle_q)
    torch.cuda.synchronize()
    ok = math.isfinite(got) and got <= REF_NOISE_FACTOR * floor
    print(f"  {cfg.name} vision tower ({vcfg.variant}), {REF_VISION_BLOCKS} blocks, grid {grid}, "
          f"merged out max|diff|/max|oracle| vs the f32 oracle: bf16 {err16:.3e}; W8A8 kernels "
          f"{got:.3e}, plain K5 {floor:.3e} (bound {REF_NOISE_FACTOR} x plain) "
          f"{'ok' if ok else 'FAIL'}")
    if not (ok and math.isfinite(err16)):
        raise AssertionError(f"{cfg.name} vision tower disagrees with the f32 oracle")
    del tower, towerq, deq
    torch.cuda.empty_cache()
    return {"bf16": err16, "w8a8": got, "w8a8_plain_k5": floor}


@contextlib.contextmanager
def _plain_verify():
    """Bind K2-verify's plain version where the decoder calls it (phase 4's
    noise floor; the serving path has no such route)."""
    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.ops import attention as A

    kernel = lang.streaming_verify_attention
    lang.streaming_verify_attention = A.verify_attention_plain
    try:
        yield
    finally:
        lang.streaming_verify_attention = kernel


VERIFY_K_PAD = 8  # spec decode's verify width at the default k_draft (7)


def phase_verify_reference(cfg) -> dict:
    """Phase 4's verify forward at 7B width (REF_LAYERS decoder layers):
    after a T = 64 chunk prefill, one spec-decode verify forward of
    VERIFY_K_PAD tokens over an empty decode delta (K2-verify), against the
    f32 full-attention oracle over the same 72 tokens, all 8 rows' logits:
    (e) over the pre-rotated bf16 arena (noise floor: the oracle in bf16),
    (f) with W8A8 weights over the int8 arena and its pre-rotated K copy
    (K5 tiled at 8 rows; against the oracle on the dequantized weights;
    noise floor: the same forward with K5's and K2-verify's plain
    versions). Each may be at most REF_NOISE_FACTOR times its floor. r:
    the largest |logit difference| over max |logit| between the verify's
    rows and K2 decode steps over the same tokens (each step writing its
    K/V into the delta, as the autoregressive loop does). Returns {case:
    r}."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops.quant import LAYER_LINEARS, quantize_language, write_slots

    tcfg = dataclasses.replace(cfg.text, num_hidden_layers=REF_LAYERS)
    rcfg = dataclasses.replace(cfg, text=tcfg)
    lm = init_params(rcfg, torch.Generator(device="cuda").manual_seed(2),
                     device="cuda", dtype=torch.bfloat16).text
    dev = lm.embed.weight.device
    T0, K, C, E = 64, VERIFY_K_PAD, 512, VERIFY_E_DELTA
    L, Hkv, hd = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, tcfg.vocab_size, T0 + K)).to(dev)
    pos = torch.arange(T0 + K, dtype=torch.float32, device=dev).expand(3, T0 + K).contiguous()
    emb = lang.embed_tokens(tcfg, lm, ids)

    def oracle(m):
        x = emb.to(m.embed.weight.dtype)
        return lang.lm_logits(tcfg, m, lang.language_forward(tcfg, m, x, pos))[T0:]

    def rel(x, ref):
        return float((x - ref).abs().max() / ref.abs().max())

    def verify_and_steps(m, int8_v: bool):
        """(the verify's logits [K, V], K2 decode steps' logits [K, V],
        K2-verify launches) for model m after the prefill."""
        kr = torch.zeros(L, C, Hkv, hd, dtype=torch.bfloat16, device=dev)  # rotated K copy
        if int8_v:
            _, va = lang.init_kv_arena(tcfg, C, torch.bfloat16, dev, quant="int8")
        else:
            va = torch.zeros_like(kr)
        arena = dict(arena=(kr, va), arena_rotated=True)
        _, (_, kbr, vb) = lang.language_forward_streaming(
            tcfg, m, emb[:T0], pos[:, :T0], visible_len=0, **arena)
        kr[:, :T0] = kbr
        write_slots(va, vb, 0)
        dk = torch.zeros(L, E, Hkv, hd, dtype=torch.bfloat16, device=dev)
        dv = torch.zeros_like(dk)
        n = A.launch_counts["streaming_verify_attention"]
        h, _ = lang.language_forward_streaming(
            tcfg, m, emb[T0:], pos[:, T0:], visible_len=T0, extra=(dk, dv), extra_visible=0,
            **arena)
        launched = A.launch_counts["streaming_verify_attention"] - n
        verify = lang.lm_logits(tcfg, m, h)
        steps = []
        for t in range(K):
            h1, (_, k1r, v1) = lang.language_forward_streaming(
                tcfg, m, emb[T0 + t : T0 + t + 1], pos[:, T0 + t : T0 + t + 1], visible_len=T0,
                extra=(dk, dv), extra_visible=t, **arena)
            dk[:, t], dv[:, t] = k1r[:, 0], v1[:, 0]
            steps.append(lang.lm_logits(tcfg, m, h1)[0])
        return verify, torch.stack(steps), launched

    out = {}
    lm32 = copy.deepcopy(lm).float()
    o32, o16 = oracle(lm32), oracle(lm)
    verify, steps, launched = verify_and_steps(lm, False)
    out["bf16 pre-rotated (K1, K2-verify)"] = (rel(verify, o32), rel(o16, o32),
                                               rel(steps, verify), launched)
    lmq = quantize_language(copy.deepcopy(lm))
    for layer, qlayer in zip(lm32.layers, lmq.layers):
        for name in LAYER_LINEARS:
            ql = getattr(qlayer, name)
            getattr(layer, name).weight.copy_(ql.q.float() * ql.s[:, None])
    lm32.lm_head.weight.copy_(lmq.lm_head.q.float() * lmq.lm_head.s[:, None])
    oq = oracle(lm32)
    verify, steps, launched = verify_and_steps(lmq, True)
    with _plain_k5(), _plain_verify():
        floor, _, _ = verify_and_steps(lmq, True)
    out["W8A8, int8 pre-rotated (K5, K1, K2-verify)"] = (rel(verify, oq), rel(floor, oq),
                                                         rel(steps, verify), launched)
    torch.cuda.synchronize()
    r = {}
    for name, (err, floor, r_case, launched) in out.items():
        ok = math.isfinite(err) and err <= REF_NOISE_FACTOR * floor and launched == L
        print(f"  verify forward, {name}: {L} layers, T={T0} prefill + {K} verify tokens, "
              f"max|diff|/max|logit| of the {K} rows vs the f32 oracle: kernels {err:.3e}, plain "
              f"{floor:.3e} (bound {REF_NOISE_FACTOR} x plain); {launched} K2-verify launches; "
              f"r (verify rows vs K2 decode steps) {r_case:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"verify forward ({name}) disagrees with the plain oracle")
        r[name] = r_case
    del lm, lm32, lmq
    torch.cuda.empty_cache()
    return r


def _ptxas_verbose(kernels, source: str) -> subprocess.Popen:
    """Start nvcc -Xptxas -v on one kernel source (its object discarded),
    beside the library's build."""
    out = kernels.BUILD_DIR / f"ptxas_{os.getpid()}.o"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(out),
         str(kernels.CSRC / source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _ptxas_text(proc: subprocess.Popen) -> str:
    """The output of a _ptxas_verbose run (its object removed)."""
    text = proc.communicate()[0]
    Path(proc.args[proc.args.index("-o") + 1]).unlink(missing_ok=True)
    if proc.returncode:
        raise RuntimeError("nvcc -Xptxas -v failed:\n" + text)
    return text


def _ptxas_lines(text: str, kernel: str) -> str:
    """ptxas's registers, shared memory and spill lines for the kernels whose
    (mangled) name contains `kernel`."""
    lines, mine = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mine = kernel in line
        elif mine and ("spill" in line or "Used" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    # ptxas's warnings name the function: e.g. wgmma products it had to
    # serialize (a pipeline that waits where the source overlaps)
    lines += [line.strip() for line in text.splitlines() if "warning" in line and kernel in line]
    return "ptxas: " + "; ".join(lines)


def _profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _report_profile(prof, wall: float, out: Path) -> None:
    """Device time by kernel over the traced slice -> out. Only device-side
    events count (an aten op's device time is its kernels')."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if t > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = [f"device busy {busy:.1f} ms of {wall * 1e3:.1f} ms wall (traced run)"]
    lines += [f"{ms:12.3f} ms {n:8d} calls  {key}" for ms, n, key in rows]
    out.write_text("\n".join(lines) + "\n")
    print("  profile: " + lines[0])
    for line in lines[1:16]:
        print("   " + line[:160])


def phase_slice(cfg, model, n_chunks: int, stream, expect: dict, profile: Path | None = None,
                recompute: bool = False):
    """Serve n_chunks through streaming_inference_frames with `stream`
    (and `recompute`). `expect` maps each kernel to its launch count per
    chunk (0 for the kernels it leaves out)."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.serve import streaming_inference_frames
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.utils.buckets import bucket_for

    rng = np.random.default_rng(0)
    # 16:9 under max_pixels_for_window(16) -> grid (1, 34, 60), 510 tokens
    frames = [rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8) for _ in range(n_chunks)]
    prof = _profiler() if profile else contextlib.nullcontext()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with prof:
        responses, times = streaming_inference_frames(
            cfg=cfg, model=model, tokenizer=FakeTokenizer(cfg.tokens), frames=frames,
            stream=stream, time_test=True, quiet=True, recompute=recompute,
        )
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    if profile:
        _report_profile(prof, wall, profile)
    for i, t in enumerate(times):
        bucket = bucket_for(t["prefill_len"], stream.prefill_buckets)
        print(f"  chunk {i:2d}: {t['gen_time_sec'] * 1e3:9.2f} ms  tokens={t['decoded_tokens']:2d}  "
              f"kv={t['kv']} (evict {t['kv_pre_evict']} -> {t['kv_post_evict']})  prefill "
              f"{t['prefill_len']} -> bucket {bucket}")
    print(f"  slice: {len(times)} chunks in {wall:.3f} s; launches {launches}")
    lat = sorted(t["gen_time_sec"] * 1e3 for t in times)
    n_frames = sum(len(f) for f in frames)
    print(f"  chunk latency p50 {statistics.median(lat):.2f} ms, max {lat[-1]:.2f} ms; "
          f"ingest {n_frames / wall:.3f} frames/s")

    assert len(times) == n_chunks, (len(times), n_chunks)
    assert all(0 < t["decoded_tokens"] <= stream.max_tokens_per_chunk + 1 for t in times)
    assert max(max(t["kv"], t["kv_pre_evict"]) for t in times) <= stream.kv_capacity
    if n_chunks > stream.visual_round:
        assert any(
            t["kv_post_evict"] < t["kv_pre_evict"] for t in times[stream.visual_round:]
        ), "no eviction happened"
    want = {k: n_chunks * expect.get(k, 0) for k in launches}
    assert launches == want, (launches, want)
    assert all(isinstance(r["response"], str) for r in responses)
    return launches, dict(chunk_p50_ms=statistics.median(lat), chunk_max_ms=lat[-1],
                          buckets=[bucket_for(t["prefill_len"], stream.prefill_buckets)
                                   for t in times])


# slice G: bench.py's single-stream route; its qa question (the bench's
# QA_QUESTION) lands at chunk QA_AT and moves that chunk to a larger bucket
QA_QUESTION = (
    " Also, what is the current score of the match, which team has the "
    "momentum right now, and who looks most likely to score next?"
)
QA_AT = 10


def phase_bench_route(cfg, model, n_chunks: int, stream, expect: dict,
                      profile: Path | None = None):
    """bench.py's single-stream route through StreamingSession: prewarm
    (every bucket's chunk step and the uint8-frames encode), one throwaway
    warm chunk, then a fresh session on the same model and n_chunks chunks
    of 2 synthetic 476x840 uint8 frames, each uploaded (`upload_frames`) and
    patchified on the card; chunk 0 takes its frames into its own step
    (frames_u8=), chunk i+1's encode is launched right after chunk i's step,
    and QA_QUESTION is injected at chunk QA_AT. A chunk's latency runs from
    its launch to its tokens on the host (the next chunk's upload and encode
    launch inside it, as in bench.py). `expect` maps each kernel to its
    launches per chunk; the counts are reset after the warm chunk."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl.model import encode_video_frames
    from streaming_vlm_tpu_torch.serve import StreamingSession
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.utils.buckets import bucket_for

    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8) for _ in range(n_chunks + 1)]
    grid = (1, 34, 60)
    tok = FakeTokenizer(cfg.tokens)
    session = StreamingSession(cfg, model, tok, stream=stream)
    t0 = time.perf_counter()
    n_variants = session.engine.prewarm(grids=(grid,), vision="frames")
    prewarm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.run_chunk(0, 0.0, frames_u8=session.engine.upload_frames(frames[-1]), grid_thw=grid)
    warm_s = time.perf_counter() - t0
    print(f"  prewarm: {n_variants} chunk-step variants + the frames encode + the gather in "
          f"{prewarm_s:.3f} s; warm chunk {warm_s:.3f} s")
    del session
    session = StreamingSession(cfg, model, tok, stream=stream)
    eng = session.engine
    prof = _profiler() if profile else contextlib.nullcontext()
    lat, info, embeds = [], [], None
    torch.cuda.synchronize()
    _reset_counts()
    t_all = time.perf_counter()
    with prof:
        for i in range(n_chunks):
            q = QA_QUESTION if i == QA_AT else ""
            t0 = time.perf_counter()
            if i == 0:
                h = session.run_chunk_async(0, 0.0, frames_u8=eng.upload_frames(frames[0]),
                                            grid_thw=grid, question=q)
            else:
                h = session.run_chunk_async(i, float(i), vis_embeds=embeds, grid_thw=grid,
                                            question=q)
            if i + 1 < n_chunks:
                embeds = encode_video_frames(cfg, model, eng.upload_frames(frames[i + 1]), grid)
            n_real = h.n_real
            _, gen = session.finish_chunk(i, h)
            lat.append((time.perf_counter() - t0) * 1e3)
            info.append((len(gen), eng.cached, eng.cached_before_evict, eng.cached_after_evict,
                         bucket_for(n_real, stream.prefill_buckets)))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = _counts()
    if profile:
        _report_profile(prof, wall, profile)
    for i, (ms, (n, kv, pre, post, b)) in enumerate(zip(lat, info)):
        print(f"  chunk {i:2d}: {ms:9.2f} ms  tokens={n:2d}  kv={kv} (evict {pre} -> {post})  "
              f"bucket {b}" + ("  (qa question)" if i == QA_AT else ""))
    # the tower's share: one chunk's frames encode alone, synchronised
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_video_frames(cfg, model, eng.upload_frames(frames[0]), grid)
        torch.cuda.synchronize()
        tower_ms = (time.perf_counter() - t0) * 1e3
    s_lat = sorted(lat)
    p50 = statistics.median(lat)
    print(f"  slice: {n_chunks} chunks in {wall:.3f} s; chunk latency p50 {p50:.2f} ms, max "
          f"{s_lat[-1]:.2f} ms; qa chunk {QA_AT} {lat[QA_AT]:.2f} ms ({lat[QA_AT] / p50:.3f} x "
          f"p50, bucket {info[QA_AT][4]}); chunk 0 {lat[0]:.2f} ms ({lat[0] / p50:.3f} x p50); "
          f"vision encode alone {tower_ms:.2f} ms ({tower_ms / p50:.1%} of p50); "
          f"launches {launches}")
    assert all(0 < n <= stream.max_tokens_per_chunk + 1 for n, *_ in info)
    assert max(max(kv, pre) for _, kv, pre, _, _ in info) <= stream.kv_capacity
    assert any(post < pre for _, _, pre, post, _ in info[stream.visual_round:]), "no eviction"
    assert info[QA_AT][4] > info[QA_AT - 1][4], "the qa chunk kept the steady bucket"
    want = {k: n_chunks * expect.get(k, 0) for k in launches}
    assert launches == want, (launches, want)
    return launches, dict(prewarm_variants=n_variants, prewarm_s=prewarm_s, warm_chunk_s=warm_s,
                          chunk_p50_ms=p50, chunk_max_ms=s_lat[-1], qa_chunk_ms=lat[QA_AT],
                          qa_bucket=info[QA_AT][4], steady_bucket=info[QA_AT - 1][4],
                          chunk0_ms=lat[0], vision_encode_ms=tower_ms)


def phase_multistream(cfg, model, stream, B: int, expect: dict, profile: Path | None = None):
    """bench.py's multi-stream setup through MultiStreamEngine: B lanes,
    each with its own query and its own synthetic 476x840 frames (2 a
    chunk, patchified on the host before a round's clock starts); the
    bench's warm round, then reset_lane on every lane; then MS_ROUNDS
    rounds (eviction from round visual_round on) with the last lane idle in
    MS_IDLE_ROUNDS. A round's wall time covers the lanes' vision encode
    (upload + B tower calls), the batched step and its one fetch. `expect`
    maps each kernel to its launches per round; the counts are reset
    after the warm round."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import SamplingConfig
    from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer, PromptBuilder
    from streaming_vlm_tpu_torch.video.ingest import patchify_frames

    v = cfg.vision
    tok = cfg.tokens
    rng = np.random.default_rng(B)
    ms = MultiStreamEngine(cfg, model, stream, SamplingConfig(), B)
    queries = [f"Commentate on match feed {b}" for b in range(B)]

    def patches():
        out = [patchify_frames(rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8),
                               patch_size=v.patch_size, temporal_patch_size=v.temporal_patch_size,
                               merge_size=v.spatial_merge_size) for _ in range(B)]
        return np.stack([p for p, _ in out]), out[0][1]

    def segs(builder, i, query, grid):
        n_vid = int(np.prod(grid)) // v.spatial_merge_unit
        out = []
        if i == 0:
            out.append(builder.system_segment())
            out.extend(builder.previous_text_segments("live stream"))
            out.extend(builder.user_turn_segments(0, 0.0, 1.0, n_vid, grid, 1.0, query=query))
        else:
            out.extend(builder.user_turn_segments(i, float(i), i + 1.0, n_vid, grid, 1.0))
        return out + builder.assistant_open_segments(i)

    # the warm round: round 0 on every lane, then every lane to a new client
    pats, grid = patches()
    warm = [PromptBuilder(tok, FakeTokenizer(tok)) for _ in range(B)]
    ms.process_round([segs(warm[b], 0, queries[b], grid) for b in range(B)],
                     vis_embeds=ms.encode_round(pats, grid), grid_thw=grid)
    for b in range(B):
        ms.reset_lane(b)
    builders = [PromptBuilder(tok, FakeTokenizer(tok)) for _ in range(B)]
    end_bias = builders[0].measure_biases()[1]
    clocks = [0] * B
    walls, frames, evictions, cached = [], 0, [], []
    prof = _profiler() if profile else contextlib.nullcontext()
    torch.cuda.synchronize()
    _reset_counts()
    t_all = time.perf_counter()
    with prof:
        for i in range(MS_ROUNDS):
            pats, grid = patches()
            lanes = [None if (b == B - 1 and i in MS_IDLE_ROUNDS) else
                     segs(builders[b], clocks[b], queries[b], grid) for b in range(B)]
            t0 = time.perf_counter()
            ve = ms.encode_round(pats, grid)
            outs = ms.process_round(lanes, vis_embeds=ve, grid_thw=grid)
            walls.append(time.perf_counter() - t0)
            for b, o in enumerate(outs):
                if o is None:
                    continue
                assert 0 < o[1] <= stream.max_tokens_per_chunk + 1, o
                ms.engines[b].commit_assistant(o[0], end_bias, clocks[b])
                clocks[b] += 1
                frames += 2
            evictions.append([e.cached_after_evict < e.cached_before_evict for e in ms.engines])
            cached.append([e.cached_after_evict for e in ms.engines])
            assert all(e.cached + e.uncached_tail == e.table.total_len() for e in ms.engines)
            assert max(e.cached for e in ms.engines) <= stream.kv_capacity
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = _counts()
    busy = None
    if profile:
        _report_profile(prof, wall, profile)
        busy = float(profile.read_text().split()[2]) / (wall * 1e3)
    for i, (w, c) in enumerate(zip(walls, cached)):
        print(f"  round {i:2d}: {w * 1e3:9.2f} ms  cached after eviction {c}"
              + ("  (last lane idle)" if i in MS_IDLE_ROUNDS else ""))
    lat = sorted(x * 1e3 for x in walls)
    agg = frames / sum(walls)
    print(f"  {B} lanes, {MS_ROUNDS} rounds in {wall:.3f} s; round wall p50 "
          f"{statistics.median(lat):.2f} ms, max {lat[-1]:.2f} ms; aggregate ingest {agg:.3f} "
          f"frames/s ({frames} frames)" + (f"; device busy {busy:.1%}" if busy else "")
          + f"; launches {launches}")
    assert any(any(r) for r in evictions[stream.visual_round:]), "no eviction happened"
    want = {k: MS_ROUNDS * expect.get(k, 0) for k in launches}
    assert launches == want, (launches, want)
    del ms
    torch.cuda.empty_cache()
    return launches, dict(lanes=B, rounds=MS_ROUNDS, round_p50_ms=statistics.median(lat),
                          round_max_ms=lat[-1], aggregate_frames_per_s=agg,
                          cached_after_eviction=cached[-1], device_busy=busy)


def _patches(cfg, rng, n: int = 1):
    """n chunks of 2 synthetic 476x840 uint8 frames, patchified on the host:
    [(patches [2040, patch_dim] f32, grid (1, 34, 60))]."""
    import numpy as np

    from streaming_vlm_tpu_torch.video.ingest import patchify_frames

    v = cfg.vision
    return [patchify_frames(rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8),
                            patch_size=v.patch_size, temporal_patch_size=v.temporal_patch_size,
                            merge_size=v.spatial_merge_size) for _ in range(n)]


def _client_segs(cfg, builder, i: int, query: str, grid):
    """Chunk i of a stream with `query` (system prompt and previous text at
    chunk 0), as bench.py's multi-stream clients send them."""
    import numpy as np

    n_vid = int(np.prod(grid)) // cfg.vision.spatial_merge_unit
    out = []
    if i == 0:
        out.append(builder.system_segment())
        out.extend(builder.previous_text_segments("live stream"))
        out.extend(builder.user_turn_segments(0, 0.0, 1.0, n_vid, grid, 1.0, query=query))
    else:
        out.extend(builder.user_turn_segments(i, float(i), i + 1.0, n_vid, grid, 1.0))
    return out + builder.assistant_open_segments(i)


def _counts():
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops import linear_ce as CE
    from streaming_vlm_tpu_torch.ops import quant as Q

    return {**A.launch_counts, **Q.launch_counts, **CE.launch_counts,
            **{f"int8_gemm/{k}": v for k, v in Q.path_counts.items()}}


def _reset_counts():
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops import linear_ce as CE
    from streaming_vlm_tpu_torch.ops import quant as Q

    A.reset_launch_counts()
    Q.reset_launch_counts()
    CE.reset_launch_counts()


SPEC_CHUNKS = 8  # slice L: chunks, each run four ways from one state
SPEC_K = 7  # draft tokens a verify round (VERIFY_K_PAD rows)


def phase_spec(cfg, model, stream, r: float, vision_products: int) -> tuple:
    """Slice L: speculative decoding on `model` (W8A8) with `stream`,
    greedy. For each of SPEC_CHUNKS chunks (2 synthetic 476x840 frames,
    patchified on the host) the engine's state is snapshotted, then the
    chunk runs autoregressively (the state carried on) and, each from the
    snapshot, by process_chunk_spec with no draft, an adversarial
    FixedDraft and a clairvoyant one fed the autoregressive tokens. Each
    spec chunk's tokens must equal the autoregressive chunk's, or part from
    them only at a step whose top-two penalised-logit gap (the spec run's
    own, recorded in `engine.spec_gaps`) is under 2 r max |logit|. The
    clairvoyant draft must take fewer rounds than none; an eviction must
    happen; launches a spec chunk: K2-verify L a round, K2 none, K1 L, K5
    tiled 7 L + the tower's + (7 L + 1) a round, the GEMV once (the
    prefill's last row). Returns (launches over the slice, stats)."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import SamplingConfig
    from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer, PromptBuilder
    from streaming_vlm_tpu_torch.streaming.specdecode import FixedDraft

    L = cfg.text.num_hidden_layers
    kv, k1, k2 = "streaming_verify_attention", "streaming_prefill_attention", \
        "streaming_decode_attention_full"
    chunks = _patches(cfg, np.random.default_rng(11), SPEC_CHUNKS)
    eng = StreamingEngine(cfg, model, stream, SamplingConfig(do_sample=False), dtype=torch.bfloat16)
    eng.spec_gaps = []
    builder = PromptBuilder(cfg.tokens, FakeTokenizer(cfg.tokens))
    _, end_bias = builder.measure_biases()
    runs = ("autoregressive", "no draft", "adversarial", "clairvoyant")
    times = {k: [] for k in runs}
    rounds = {k: [] for k in runs[1:]}
    total, divergences, evicted = {}, [], False

    def run(name, fn):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        gen, _ = fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        c = _counts()
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        return gen, c

    for i, (px, grid) in enumerate(chunks):
        segs = _client_segs(cfg, builder, i, "Commentate on this match", grid)
        before = eng.snapshot()
        g_ar, c = run("autoregressive", lambda: eng.process_chunk(segs, px, grid))
        evicted |= eng.cached_after_evict < eng.cached_before_evict
        assert c[kv] == 0 and c[k1] == L and c[k2] == L * stream.max_tokens_per_chunk, c
        eng.commit_assistant(g_ar, end_bias, i)
        after = eng.snapshot()
        for name, draft in (("no draft", None),
                            ("adversarial", FixedDraft(np.full(64, 1000, np.int32))),
                            ("clairvoyant", FixedDraft(g_ar))):
            eng.restore(before)
            g, c = run(name, lambda: eng.process_chunk_spec(segs, px, grid, draft_fn=draft,
                                                            k_draft=SPEC_K))
            n = eng._spec_rounds
            rounds[name].append(n)
            want = {kv: L * n, k2: 0, k1: L, "int8_gemm/gemv": 1,
                    "int8_gemm/tiled": 7 * L + vision_products + n * (7 * L + 1)}
            got = {k: c[k] for k in want}
            assert got == want, (name, i, got, want)
            if not np.array_equal(g, g_ar):
                m = min(len(g), len(g_ar))
                p = next((j for j in range(m) if g[j] != g_ar[j]), m)
                gap, mx = eng.spec_gaps[p] if p < len(eng.spec_gaps) else (math.nan, math.nan)
                ok = gap < 2 * r * mx
                divergences.append(dict(chunk=i, run=name, step=p, gap=gap, max_logit=mx, ok=ok))
                print(f"  chunk {i} {name}: parts from the autoregressive tokens at step {p}: "
                      f"top-two gap {gap:.4f} against 2 r max|logit| = {2 * r * mx:.4f} "
                      f"{'ok' if ok else 'FAIL'}")
                assert ok, f"slice L: spec tokens part from the autoregressive run at chunk {i}"
        eng.restore(after)
        print(f"  chunk {i}: {len(g_ar)} tokens, kv={eng.cached} (evict {eng.cached_before_evict} "
              f"-> {eng.cached_after_evict}); rounds no draft / adversarial / clairvoyant "
              f"{rounds['no draft'][-1]} / {rounds['adversarial'][-1]} / "
              f"{rounds['clairvoyant'][-1]}; ms " + " / ".join(
                  f"{times[k][-1] * 1e3:.1f}" for k in runs))
    print(f"  slice L: the spec runs parted from the autoregressive tokens at {len(divergences)} "
          f"step(s), each inside 2 r max|logit| (r = {r:.3e})")
    assert evicted, "slice L: no eviction happened"
    assert sum(rounds["clairvoyant"]) < sum(rounds["no draft"]), rounds
    stats = {"rounds": {k: sum(v) for k, v in rounds.items()}, "divergences": divergences,
             "r": r}
    for k in runs:
        lat = sorted(t * 1e3 for t in times[k])
        stats[k] = dict(chunk_p50_ms=statistics.median(lat), chunk_max_ms=lat[-1])
        print(f"  {k}: chunk p50 {statistics.median(lat):.2f} ms, max {lat[-1]:.2f} ms" + (
            f", {sum(rounds[k])} rounds for {SPEC_CHUNKS} chunks" if k in rounds else ""))
    del eng
    torch.cuda.empty_cache()
    return total, stats


SNAP_CHUNKS, SNAP_CUT = 12, 6  # slice J: a stream of 12 chunks, cut after 6
SNAP_LANES, SNAP_ROUNDS = 4, 17  # slice J's lanes: rounds past the 16-chunk window


def phase_snapshots(cfg, model, stream, expect: tuple) -> tuple:
    """Slice J: snapshots on W8A8 weights with `stream`, sampled (default
    SamplingConfig). Run A serves SNAP_CHUNKS chunks straight through
    `streaming_inference_frames`; run B serves SNAP_CUT through a
    StreamingSession, then session.snapshot() -> save_snapshot -> a fresh
    engine (load_snapshot -> resume_snapshot=) for the rest: chunks
    SNAP_CUT.. of run B must equal run A's. Done over the pre-rotated
    arena (K1, K2) and the raw one (prerotate_arena=False: K1 raw, K3).
    Then SNAP_ROUNDS rounds of a SNAP_LANES-lane engine (the window full),
    every lane snapshotted (lane 1 through a file) into a fresh engine: one
    more round on both must give lane 1 the same tokens. Prints the
    snapshot's bytes and the ms of snapshot, save, load and restore.
    `expect`: the kernels that must have launched."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import SamplingConfig
    from streaming_vlm_tpu_torch.serve import StreamingSession, streaming_inference_frames
    from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer, PromptBuilder
    from streaming_vlm_tpu_torch.streaming.snapshot import load_snapshot, save_snapshot

    def snapshot_bytes(snap):  # the arrays' bytes (the arena prefix dominates)
        return sum(sum(a.nbytes for a in v.values()) if isinstance(v, dict) else v.nbytes
                   for v in (snap[k] for k in ("k", "v", "ids", "pos")))

    tok = FakeTokenizer(cfg.tokens)
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8) for _ in range(SNAP_CHUNKS)]
    v = cfg.vision
    path = REPO / "build" / f"snapshot_{os.getpid()}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    _reset_counts()
    for label, st in (("pre-rotated", stream),
                      ("raw", dataclasses.replace(stream, prerotate_arena=False))):
        kw = dict(cfg=cfg, model=model, tokenizer=tok, stream=st, quiet=True)
        run_a = [r["response"] for r in streaming_inference_frames(frames=frames, **kw)]
        sess = StreamingSession(cfg, model, tok, stream=st)
        from streaming_vlm_tpu_torch.video.ingest import patchify_frames

        head = []
        for i in range(SNAP_CUT):
            patches, grid = patchify_frames(frames[i], patch_size=v.patch_size,
                                            temporal_patch_size=v.temporal_patch_size,
                                            merge_size=v.spatial_merge_size)
            head.append(sess.run_chunk(i, float(i), pixel_patches=patches, grid_thw=grid)[0])
        snap, snap_ms = timed(sess.snapshot)
        _, save_ms = timed(lambda: save_snapshot(snap, str(path)))
        del sess
        torch.cuda.empty_cache()
        loaded, load_ms = timed(lambda: load_snapshot(str(path)))
        run_b = [r["response"] for r in streaming_inference_frames(
            frames=frames, resume_snapshot=loaded, **kw)]
        same_head = sum(a == b for a, b in zip(head, run_a[:SNAP_CUT]))
        same_tail = sum(a == b for a, b in zip(run_b, run_a[SNAP_CUT:]))
        print(f"  J {label}: run B chunks 0-{SNAP_CUT - 1} through the session equal run A's in "
              f"{same_head} of {SNAP_CUT}; snapshot at chunk {SNAP_CUT} ({snap['cached']} cached "
              f"slots, {snapshot_bytes(snap) / 2**20:.1f} MiB): snapshot {snap_ms:.2f} ms, save "
              f"{save_ms:.2f} ms, load {load_ms:.2f} ms; resumed chunks {SNAP_CUT}-"
              f"{SNAP_CHUNKS - 1} equal run A's in {same_tail} of {SNAP_CHUNKS - SNAP_CUT}")
        assert len(run_b) == SNAP_CHUNKS - SNAP_CUT, len(run_b)
        assert run_b == run_a[SNAP_CUT:], "the resumed stream's tokens differ from run A's"
        out[label] = dict(cached=int(snap["cached"]), bytes=snapshot_bytes(snap),
                          snapshot_ms=snap_ms, save_ms=save_ms, load_ms=load_ms,
                          head_equal=same_head, tail_equal=same_tail)

    # lanes: SNAP_ROUNDS rounds fill the window, then every lane moves
    sampling = SamplingConfig()
    ms1 = MultiStreamEngine(cfg, model, stream, sampling, SNAP_LANES)
    builders = [PromptBuilder(cfg.tokens, tok) for _ in range(SNAP_LANES)]
    end_bias = builders[0].measure_biases()[1]
    queries = [f"Commentate on match feed {b}" for b in range(SNAP_LANES)]

    def round_inputs(i):
        pats = _patches(cfg, rng, SNAP_LANES)
        grid = pats[0][1]
        return ([_client_segs(cfg, builders[b], i, queries[b], grid) for b in range(SNAP_LANES)],
                np.stack([p for p, _ in pats]), grid)

    for i in range(SNAP_ROUNDS):
        segs, pats, grid = round_inputs(i)
        outs = ms1.process_round(segs, vis_embeds=ms1.encode_round(pats, grid), grid_thw=grid)
        ms1.commit_assistant([o[0] for o in outs], end_bias, i)
    snaps, ms_snap = [], []
    for b in range(SNAP_LANES):
        sn, t = timed(lambda: ms1.snapshot_lane(b))
        snaps.append(sn)
        ms_snap.append(t)
    _, save_ms = timed(lambda: save_snapshot(snaps[1], str(path)))
    snaps[1], load_ms = timed(lambda: load_snapshot(str(path)))
    path.unlink(missing_ok=True)
    ms2 = MultiStreamEngine(cfg, model, stream, sampling, SNAP_LANES)
    ms_restore = []
    for b in range(SNAP_LANES):
        _, t = timed(lambda: ms2.restore_lane(b, snaps[b]))
        ms_restore.append(t)
    segs, pats, grid = round_inputs(SNAP_ROUNDS)
    o1 = ms1.process_round(segs, vis_embeds=ms1.encode_round(pats, grid), grid_thw=grid)
    o2 = ms2.process_round(segs, vis_embeds=ms2.encode_round(pats, grid), grid_thw=grid)
    equal = [np.array_equal(a[0], b[0]) for a, b in zip(o1, o2)]
    lane = dict(lanes=SNAP_LANES, rounds=SNAP_ROUNDS, cached=int(snaps[1]["cached"]),
                bytes=snapshot_bytes(snaps[1]), snapshot_lane_ms=ms_snap[1], save_ms=save_ms,
                load_ms=load_ms, restore_lane_ms=ms_restore[1], lanes_equal=equal)
    out["lanes"] = lane
    torch.cuda.synchronize()
    launches = _counts()
    print(f"  J lanes: {SNAP_LANES} lanes after {SNAP_ROUNDS} rounds, lane 1 {lane['cached']} "
          f"cached slots ({lane['bytes'] / 2**20:.1f} MiB): snapshot_lane {ms_snap[1]:.2f} ms "
          f"(all lanes {[round(t, 2) for t in ms_snap]}), save {save_ms:.2f} ms, load "
          f"{load_ms:.2f} ms, restore_lane {ms_restore[1]:.2f} ms (all "
          f"{[round(t, 2) for t in ms_restore]}); the next round's tokens equal, by lane, "
          f"{equal}; launches {launches}")
    assert equal[1], "lane 1's continuation differs after the move"
    missing = [k for k in expect if not launches.get(k)]
    assert not missing, f"slice J launched no {missing}"
    del ms1, ms2
    torch.cuda.empty_cache()
    return launches, out


SERVER_LANES, SERVER_CLIENTS, SERVER_CHUNKS = 4, 8, 10  # slice K


def phase_server(cfg, model, stream, expect: tuple) -> tuple:
    """Slice K: MultiStreamServer over a SERVER_LANES-lane engine (W8A8,
    `stream`), max_clients=SERVER_CLIENTS: that many clients, each its own
    frames, query and sampling seed, submit SERVER_CHUNKS chunks each; the
    background thread (start / stop) drives the rounds. Every client must
    receive chunks 0.. in order, and swaps must happen. Then the same again
    with an engine_factory and one RuntimeError("UNAVAILABLE: ...")
    injected into the 6th round: one recovery, no chunk lost; prints how
    many tokens equal the unfaulted run's. `expect`: the kernels that must
    have launched in the unfaulted run."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import SamplingConfig
    from streaming_vlm_tpu_torch.streaming.multiserve import MultiStreamServer
    from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer, PromptBuilder

    tok = FakeTokenizer(cfg.tokens)
    rng = np.random.default_rng(11)
    chunks = [_patches(cfg, rng, SERVER_CHUNKS) for _ in range(SERVER_CLIENTS)]
    queries = [f"Commentate on match feed {k}" for k in range(SERVER_CLIENTS)]
    end_bias = PromptBuilder(cfg.tokens, tok).measure_biases()[1]

    def run(fault_round=None):
        swap_ms, round_s, calls = [], [], [0]

        def swap(fn, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            swap_ms.append((time.perf_counter() - t0) * 1e3)
            return r

        # timed swaps and rounds, and the injected fault, by subclasses: a
        # wrapper set on an instance that closes over its bound method would
        # be a reference cycle holding the engine, its arena and the model
        # until the cycle collector runs
        class Engine(MultiStreamEngine):
            def snapshot_lane(self, *a):
                return swap(super().snapshot_lane, *a)

            def restore_lane(self, *a):
                return swap(super().restore_lane, *a)

            def process_round(self, *a, **k):
                calls[0] += 1
                if calls[0] == fault_round:
                    raise RuntimeError("UNAVAILABLE: device fault injected by chip_smoke.py")
                return super().process_round(*a, **k)

        class Server(MultiStreamServer):
            def _round_locked(self):
                t0 = time.perf_counter()
                n = super()._round_locked()
                if n:
                    round_s.append(time.perf_counter() - t0)
                return n

        def engine():
            return Engine(cfg, model, stream, SamplingConfig(), SERVER_LANES)

        ms = engine()
        srv = Server(ms, end_bias=end_bias, max_clients=SERVER_CLIENTS,
                     engine_factory=engine if fault_round else None, snapshot_every=4)
        clients = [srv.attach(seed=1000 + k) for k in range(SERVER_CLIENTS)]
        builders = [PromptBuilder(cfg.tokens, tok) for _ in range(SERVER_CLIENTS)]
        t0 = time.perf_counter()
        srv.start()
        try:
            for i in range(SERVER_CHUNKS):
                for k, c in enumerate(clients):
                    patches, grid = chunks[k][i]
                    c.submit(_client_segs(cfg, builders[k], i, queries[k], grid),
                             pixel_patches=patches, grid_thw=grid)
            got = [[c.get(timeout=900) for _ in range(SERVER_CHUNKS)] for c in clients]
        finally:
            srv.stop()
        wall = time.perf_counter() - t0
        assert srv.error is None, srv.error
        for k, rows in enumerate(got):
            assert [i for i, _ in rows] == list(range(SERVER_CHUNKS)), (k, [i for i, _ in rows])
        stats = dict(rounds=len(round_s), swaps=srv.swaps, recoveries=srv.recoveries,
                     swap_ms_p50=statistics.median(swap_ms) if swap_ms else None,
                     swap_ms_max=max(swap_ms) if swap_ms else None,
                     round_p50_ms=statistics.median(round_s) * 1e3,
                     round_max_ms=max(round_s) * 1e3,
                     aggregate_frames_per_s=2 * SERVER_CLIENTS * SERVER_CHUNKS / wall, wall_s=wall)
        del srv, ms
        torch.cuda.empty_cache()
        return [[g for _, g in rows] for rows in got], stats

    torch.cuda.synchronize()
    _reset_counts()
    base, stats = run()
    torch.cuda.synchronize()
    launches = _counts()
    print(f"  K: {SERVER_CLIENTS} clients on {SERVER_LANES} lanes, {SERVER_CHUNKS} chunks each, "
          f"background thread: {stats['rounds']} rounds, {stats['swaps']} swaps (snapshot_lane / "
          f"restore_lane p50 {stats['swap_ms_p50']:.2f} ms, max {stats['swap_ms_max']:.2f}), round "
          f"wall p50 {stats['round_p50_ms']:.2f} ms, max {stats['round_max_ms']:.2f} ms, aggregate "
          f"{stats['aggregate_frames_per_s']:.3f} frames/s ({stats['wall_s']:.3f} s); every client "
          f"got chunks 0-{SERVER_CHUNKS - 1} in order; launches {launches}")
    assert stats["swaps"] > 0, "no swap happened"
    missing = [k for k in expect if not launches.get(k)]
    assert not missing, f"slice K launched no {missing}"
    faulted, fstats = run(fault_round=6)
    same = sum(int(np.array_equal(a, b)) for ra, rb in zip(base, faulted) for a, b in zip(ra, rb))
    toks = sum(min(len(a), len(b)) for ra, rb in zip(base, faulted) for a, b in zip(ra, rb))
    same_tok = sum(int((a[:len(b)] == b[:len(a)]).sum()) for ra, rb in zip(base, faulted)
                   for a, b in zip(ra, rb))
    print(f"  K with engine_factory, a device fault in round 6: {fstats['recoveries']} "
          f"recovery, {fstats['rounds']} rounds, no chunk lost; chunks equal to the unfaulted "
          f"run's {same} of {SERVER_CLIENTS * SERVER_CHUNKS}, tokens {same_tok} of {toks}")
    assert fstats["recoveries"] == 1, fstats
    stats["faulted"] = dict(fstats, chunks_equal=same, tokens_equal=same_tok, tokens=toks)
    return launches, stats


# ---- training: K1's log-sum-exp, K1-bwd and CE-row (phase 3), the
# training gradients against the plain path (phase 4), slice M (phase 5)

# K1-bwd (bf16 out, f32 accumulation) against the plain algebra in f32 from
# the same bf16 inputs: two bf16 ulps of each value (2^-7 each, relative)
# plus two of the tensor's largest |value|
BWD_TOL = 2.0**-6
# ragged causal edges: 200 and 640 end no row tile (9 tokens at G = 7); the
# timings run at the last. G = 8 (Qwen2.5-VL-3B's widths: H 16, Hkv 2) at BWD_T_G8
BWD_T = (64, 200, 640, 2048, 8192)
BWD_T_G8 = (200, 2048)
BWD_PLAIN_ROWS = 512
# CE-row against the plain f32 row pass: the NLL to 1e-5 relative (plus
# 1e-5 of the largest), dlog to 1e-5 of each value (no absolute floor: at
# logits of scale 4 most of a row's probabilities are far below 1e-6, and a
# kernel that dropped them must fail). Logits N(0, 1) times each of
# CE_SCALES: 4 spreads a row's probabilities over ~17 decades, 1 is about the
# main path's (random weights: the 0.02-scaled lm_head over a normed hidden
# state of width 3584 gives logits of ~1.2), where each is ~1/V
CE_NLL_TOL, CE_DLOG_RTOL = 1e-5, 1e-5
CE_SCALES = (4.0, 1.0)
LSE_TOL = 1e-5  # K1's log-sum-exp against its plain version, relative (plus 1e-5 of the largest)
CE_ROWS = (1, 77, 2048)
VOCAB_7B = 152064
# phase 4: sft_loss at 7B widths, REF_LAYERS decoder layers, through the
# kernels in bf16 against the plain path in f32: the loss's relative error
# and each text gradient leaf's relative L2 error, each within its limit or
# within REF_NOISE_FACTOR times the plain bf16 path's own error (bf16
# rounding alone takes a small gradient, as the last layer's q_proj, to
# ~4.9e-2)
TRAIN_REF_T = 2048
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-2, 5e-2
# slice M: the decoder cut to TRAIN_LAYERS layers, a synthetic clip of
# TRAIN_CLIP seconds at 476x840, TRAIN_CLIP_FPS frames a second
TRAIN_LAYERS = 4
TRAIN_CLIP, TRAIN_CLIP_FPS = 10, 4


def _check_bwd(got, want, cases):
    atol = BWD_TOL * float(want.float().abs().max())
    return _check("K1-bwd", got, want, cases, atol, BWD_TOL)


def _phase_k1_lse(g, ka, va) -> dict:
    """K1's log-sum-exp output against `prefill_lse_plain`: rows the plan
    keeps whole and rows it splits (merged by the merge pass), both arena
    modes; K1's output with the LSE asked for is bitwise its output
    without. Times K1 at the training forward's shape (T = 8192, visible
    0) with and without the LSE."""
    import torch

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    H, Hkv, hd, C = 28, 4, 128, ka.shape[0]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ang = torch.randn(C, hd // 2, generator=g, device=dev)
    acos2 = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    asin2 = torch.cat([ang.sin(), ang.sin()], -1).contiguous()

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    err = 0.0
    for T, vis in ((200, 0), (64, 4001), (640, C - 640), (2048, 0)):
        q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
        split = len(A.prefill_plan(T, H // Hkv, Hkv, vis, n_sms).merges) > 0
        for mode, (c2, s2) in (("prerotated", (None, None)), ("raw", (acos2, asin2))):
            lse = torch.full((T, H), math.nan, device=dev)
            out = A.streaming_prefill_attention(q, ka, va, c2, s2, ks, vs, vis, lse=lse)
            ref = A.prefill_lse_plain(q, ka, c2, s2, ks, vis)
            cases = dict(T=T, visible_len=vis, mode=mode, split_rows=split)
            err = max(err, _check("K1", lse, ref, dict(cases, out="lse"),
                                  LSE_TOL * float(ref.abs().max()), LSE_TOL))
            _check_equal("K1", out, A.streaming_prefill_attention(q, ka, va, c2, s2, ks, vs, vis),
                         dict(cases, out="with lse"))
    r = dict(max_abs_err=err)
    T = 8192
    q, k, v = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    lse = torch.empty(T, H, device=dev)
    with_lse = lambda: A.streaming_prefill_attention(q, k, v, None, None, k, v, 0, lse=lse)  # noqa: E731
    without = lambda: A.streaming_prefill_attention(q, k, v, None, None, k, v, 0)  # noqa: E731
    r["t8192_device_ms"] = _device_ms(with_lse, n=5)
    r["t8192_device_ms_without_lse"] = _device_ms(without, n=5)
    print(f"  K1 with its log-sum-exp, T={T} visible 0: device {r['t8192_device_ms']:.4f} ms "
          f"(without it {r['t8192_device_ms_without_lse']:.4f} ms)")
    return r


def _sdpa_backend(names) -> str:
    """SDPA's backend, read from the CUDA kernel names of a traced call."""
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cuDNN"), ("flash", "flash attention"),
                         ("fmha", "memory-efficient (CUTLASS fmha)"), ("efficient", "memory-efficient")):
        if key in text:
            return backend
    return "math (unfused)"


def _phase_k1_bwd(g) -> dict:
    """K1-bwd against `train_attention_bwd_plain` in f32 from the same bf16
    inputs (O and the log-sum-exp from the plain forward, so that K1's own
    checks stay apart), at T in BWD_T (7B widths, G = 7) and BWD_T_G8 (3B
    widths, G = 8), and two calls bitwise equal; times at the last T beside
    K1's forward, the bound, SDPA's causal forward + backward and, as the
    library calls (timed only), SDPA's own autograd backward (one forward,
    then the backward repeated; its backend named from the kernels it
    runs) and aten's flash-attention backward from its own forward's saved
    output and log-sum-exp, both over K and V repeated to the H query heads
    (the sum of their dK and dV over each kv head's G heads is not in the
    times); the library time is the faster of the two."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    hd = 128

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    err = 0.0
    for (H, Hkv), ts in (((16, 2), BWD_T_G8), ((28, 4), BWD_T)):
        for T in ts:
            q, k, v, do = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd), rn(T, H, hd)
            with torch.no_grad():
                o, lse2 = A.train_attention_plain(q.float(), k.float(), v.float(), BWD_PLAIN_ROWS,
                                                  return_lse=True)
            o = o.reshape(T, H, hd).to(torch.bfloat16)
            got = A.attention_bwd(q, k, v, o, lse2, do)
            want = A.train_attention_bwd_plain(q, k, v, o, lse2, do, BWD_PLAIN_ROWS)
            again = A.attention_bwd(q, k, v, o, lse2, do)
            for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
                cases = dict(T=T, G=H // Hkv, grad=name)
                err = max(err, _check_bwd(a, b, cases))
                _check_equal("K1-bwd", c, a, dict(cases, repeat=True))
            del want, got, again
            torch.cuda.empty_cache()
    r = dict(max_abs_err=err, T=T)  # the timings: the last case's inputs (7B widths)
    lse = torch.empty(T, H, device=dev)
    fwd = lambda: A.streaming_prefill_attention(q, k, v, None, None, k, v, 0, lse=lse)  # noqa: E731
    bwd = lambda: A.attention_bwd(q, k, v, o, lse2, do)  # noqa: E731
    r["ms"], r["device_ms"] = _median_ms(bwd, reps=5, batch=3), _device_ms(bwd, n=5)
    r["fwd_ms"], r["fwd_device_ms"] = _median_ms(fwd, reps=5, batch=3), _device_ms(fwd, n=5)
    r["plain_ms"] = _median_ms(lambda: A.train_attention_bwd_plain(q, k, v, o, lse2, do,
                                                                   BWD_PLAIN_ROWS), reps=2, batch=1)
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None].contiguous()  # noqa: E731
    qq, kk, vv = (x.requires_grad_() for x in (q.transpose(0, 1)[None].contiguous(), rep(k), rep(v)))
    dd = do.transpose(0, 1)[None].contiguous()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        torch.autograd.grad(out, (qq, kk, vv), dd)

    with torch.no_grad():
        r["sdpa_fwd_ms"] = _median_ms(
            lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True), reps=5, batch=3)
    r["sdpa_fwd_bwd_ms"] = _median_ms(sdpa_fwd_bwd, reps=5, batch=3)
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qq, kk, vv), dd, retain_graph=True)  # noqa: E731
    r["sdpa_bwd_ms"] = _median_ms(sdpa_bwd, reps=5, batch=3)
    r["sdpa_bwd_backend"] = (_sdpa_backend([e.name for e in _traced_calls(sdpa_bwd, 1).events()
                                            if str(e.device_type).endswith("CUDA")])
                             if _TIMED else None)
    del out
    with torch.no_grad():
        fo, flse, cq, ck, mq, mk, seed, off, _ = torch.ops.aten._scaled_dot_product_flash_attention(
            qq, kk, vv, 0.0, True)
        r["flash_bwd_ms"] = _median_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dd, qq, kk, vv, fo, flse, cq, ck, mq, mk, 0.0, True, seed, off), reps=5, batch=3)
    r["library_ms"] = min(r["sdpa_bwd_ms"], r["flash_bwd_ms"])
    del qq, kk, vv, dd, fo, flse
    flops = 5 * 2 * H * hd * T * (T + 1) / 2  # S, dP, dV, dK, dQ over the causal half
    r["bound_ms"], r["bound_by"] = _bound(_nbytes(q, k, v, o, do, lse2) + _nbytes(q, k, v), flops)
    if _TIMED:
        dev_ms = r["device_ms"] or r["ms"]
        r["tflops"] = flops / (dev_ms * 1e-3) / 1e12
        print(f"  K1-bwd T={T}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, "
              f"{r['tflops']:.1f} TFLOP/s of the 5 products, {100 * r['bound_ms'] / dev_ms:.1f}% "
              f"of the bound), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); K1 forward with lse {r['fwd_ms']:.4f} ms (device "
              f"{r['fwd_device_ms']:.4f}); K1 + K1-bwd {r['fwd_ms'] + r['ms']:.4f} ms against SDPA "
              f"causal forward + backward {r['sdpa_fwd_bwd_ms']:.4f} ms (forward "
              f"{r['sdpa_fwd_ms']:.4f}; timed only); library (timed only): SDPA's autograd "
              f"backward {r['sdpa_bwd_ms']:.4f} ms ({r['sdpa_bwd_backend']}), aten flash-attention "
              f"backward {r['flash_bwd_ms']:.4f} ms")
    del q, k, v, o, do, lse2, lse
    torch.cuda.empty_cache()
    return r


# the full-block modes (ring attention's key blocks wholly before the
# queries): T queries over T keys; 200 ends no K1 row tile (G = 7) and no
# key tile; RING_T is the ring's block at T = 8192 over {"seq": 2}
FULL_T = (200, 640, 2048)
RING_T = 4096


def _phase_full_block(g) -> dict:
    """K1's and K1-bwd's full-block modes against their plain versions (the
    checks labelled K1 and K1-bwd, mode 'full-block'):
    K1's output (K1's tolerance) and log-sum-exp (LSE_TOL) against
    `full_block_attention_plain` / `prefill_lse_plain` without the self
    block, K1-bwd's (BWD_TOL, two calls bitwise) against
    `train_attention_bwd_plain(..., causal=False)` from the plain f32
    forward's O and lse, at T in FULL_T + (RING_T,) (7B widths, G = 7) and
    T = 640 at G = 8; times both at the ring's block (T = RING_T) beside
    their bounds, the plain versions and SDPA non-causal (forward; forward
    + backward, and its backward alone as the library call of K1-bwd's
    mode). Causal K1-bwd at BWD_T[-1] before and after all of that must be
    bitwise equal (mode 'causal': the clusters share K1-bwd's scratch)."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    hd = 128

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    # causal K1-bwd at BWD_T's last shape, before and after the full-block
    # calls: bitwise equal (no scratch or counter left dirty by the
    # clusters); O and the log-sum-exp from the plain forward, as in
    # _phase_k1_bwd, so that K1's own checks stay apart
    H, Hkv, T = 28, 4, BWD_T[-1]
    qc, kc, vc, doc = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd), rn(T, H, hd)
    with torch.no_grad():
        oc, lc = A.train_attention_plain(qc.float(), kc.float(), vc.float(), BWD_PLAIN_ROWS,
                                         return_lse=True)
    oc = oc.reshape(T, H, hd).to(torch.bfloat16)
    causal_before = A.attention_bwd(qc, kc, vc, oc, lc, doc)
    err_f, err_b = 0.0, 0.0
    for (H, Hkv), ts in (((16, 2), (640,)), ((28, 4), FULL_T + (RING_T,))):
        for T in ts:
            q, k, v, do = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd), rn(T, H, hd)
            cases = dict(T=T, G=H // Hkv, mode="full-block")
            lse = torch.full((T, H), math.nan, device=dev)
            out = A.full_block_attention(q, k, v, lse=lse)
            with torch.no_grad():
                ref, lse_f32 = A.full_block_attention_plain(q.float(), k.float(), v.float())
            err_f = max(err_f, _check("K1", out, ref,
                                      dict(cases, out="o"), K1_ATOL_FRAC * float(ref.abs().max()),
                                      K1_RTOL))
            ref_lse = A.prefill_lse_plain(q, k, None, None, None, T)
            err_f = max(err_f, _check("K1", lse, ref_lse, dict(cases, out="lse"),
                                      LSE_TOL * float(ref_lse.abs().max()), LSE_TOL))
            o = ref.to(torch.bfloat16)
            got = A.attention_bwd(q, k, v, o, lse_f32, do, causal=False)
            want = A.train_attention_bwd_plain(q, k, v, o, lse_f32, do, BWD_PLAIN_ROWS,
                                               causal=False)
            again = A.attention_bwd(q, k, v, o, lse_f32, do, causal=False)
            for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
                atol = BWD_TOL * float(b.float().abs().max())
                err_b = max(err_b, _check("K1-bwd", a, b, dict(cases, grad=name), atol,
                                          BWD_TOL))
                _check_equal("K1-bwd", c, a, dict(cases, grad=name, repeat=True))
            del got, want, again, ref
            torch.cuda.empty_cache()
    # timings at the ring's block: the last case's inputs
    T = RING_T
    fwd = lambda: A.full_block_attention(q, k, v, lse=lse)  # noqa: E731
    bwd = lambda: A.attention_bwd(q, k, v, o, lse_f32, do, causal=False)  # noqa: E731
    kf = dict(max_abs_err=err_f, T=T, ms=_median_ms(fwd, reps=5, batch=3),
              device_ms=_device_ms(fwd, n=5),
              plain_ms=_median_ms(lambda: A.full_block_attention_plain(q, k, v), reps=2, batch=1))
    kb = dict(max_abs_err=err_b, T=T, ms=_median_ms(bwd, reps=5, batch=3),
              device_ms=_device_ms(bwd, n=5),
              plain_ms=_median_ms(lambda: A.train_attention_bwd_plain(
                  q, k, v, o, lse_f32, do, BWD_PLAIN_ROWS, causal=False), reps=2, batch=1))
    qq, kk, vv, _ = _sdpa_inputs(q, k, v, None)
    qq, kk, vv = (x.requires_grad_() for x in (qq, kk, vv))
    dd = do.transpose(0, 1)[None].contiguous()
    with torch.no_grad():
        sdpa = lambda: F.scaled_dot_product_attention(qq, kk, vv)  # noqa: E731
        kf["library_ms"] = _median_ms(sdpa, reps=5, batch=3)
        kf["library_backend"] = (_sdpa_backend([e.name for e in _traced_calls(sdpa, 1).events()
                                                if str(e.device_type).endswith("CUDA")])
                                 if _TIMED else None)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qq, kk, vv), (qq, kk, vv), dd)

    kb["sdpa_fwd_bwd_ms"] = _median_ms(sdpa_fwd_bwd, reps=5, batch=3)
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv)
    kb["library_ms"] = _median_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), dd,
                                                              retain_graph=True), reps=5, batch=3)
    del sdpa_out, qq, kk, vv, dd
    for name, a, b in zip(("dq", "dk", "dv"), A.attention_bwd(qc, kc, vc, oc, lc, doc),
                          causal_before):
        _check_equal("K1-bwd", a, b, dict(T=qc.shape[0], G=7, grad=name, mode="causal",
                                          after="full-block calls"))
    del qc, kc, vc, doc, lc, oc, causal_before
    f_flops = 4 * H * hd * T * T  # S and P.V over every (query, key) pair
    kf["bound_ms"], kf["bound_by"] = _bound(_nbytes(q, k, v, q) + 4 * T * H, f_flops)
    kb["bound_ms"], kb["bound_by"] = _bound(_nbytes(q, k, v, o, do, lse_f32) + _nbytes(q, k, v),
                                            5 * 2 * H * hd * T * T)
    if _TIMED:
        for what, r in (("K1 full-block", kf), ("K1-bwd full-block", kb)):
            dev_ms = r["device_ms"] or r["ms"]
            print(f"  {what} T={T} over {T} keys: kernel {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f} ms, {100 * r['bound_ms'] / dev_ms:.1f}% of the bound), "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"SDPA non-causal {'backward' if r is kb else 'forward'} {r['library_ms']:.4f} ms"
                  + (f" ({kf['library_backend']})" if r is kf else "")
                  + (f" (forward + backward {kb['sdpa_fwd_bwd_ms']:.4f} ms; K1 full + K1-bwd "
                     f"full {kf['ms'] + kb['ms']:.4f} ms)" if r is kb else ""))
    del q, k, v, o, do, lse, lse_f32
    torch.cuda.empty_cache()
    return {"full_block_attention": kf, "attention_bwd_full": kb}


def _phase_ce_rows(g) -> dict:
    """CE-row against `ce_rows_plain` at the 7B vocabulary, rows in CE_ROWS,
    logits at each of CE_SCALES, targets 0 and V - 1 and masked rows among
    them, with and without the gradient; times [2048, V] (scale 1) beside its byte bound and F.cross_entropy's
    forward + backward on the same logits (another function, timed only)."""
    import torch
    import torch.nn.functional as F

    from streaming_vlm_tpu_torch.ops import linear_ce as CE

    dev, V = "cuda", VOCAB_7B
    err = 0.0
    for rows in CE_ROWS:
        for scale in CE_SCALES:
            logits = torch.randn(rows, V, generator=g, device=dev) * scale
            tgt = torch.randint(0, V, (rows,), generator=g, device=dev)
            tgt[0] = V - 1 if rows == 1 else 0
            if rows > 1:
                tgt[1] = V - 1
            mask = (torch.rand(rows, generator=g, device=dev) > 0.25).float()
            mask[0] = 1.0
            if rows > 2:
                mask[2] = 0.0
            for grads in (False, True):
                a, b = logits.clone(), logits.clone()
                nll = CE.ce_rows(a, tgt, mask, grads)
                ref = CE.ce_rows_plain(b, tgt, mask, grads)
                cases = dict(rows=rows, V=V, scale=scale, grads=grads)
                err = max(err, _check("CE-row", nll, ref, dict(cases, out="nll"),
                                      CE_NLL_TOL * float(ref.abs().max()), CE_NLL_TOL))
                if grads:
                    err = max(err, _check("CE-row", a, b, dict(cases, out="dlog"), 0.0,
                                          CE_DLOG_RTOL))
                else:
                    _check_equal("CE-row", a, logits, dict(cases, out="logits untouched"))
            del a, b
    r = dict(max_abs_err=err, rows=rows, V=V, library_ms=None)
    call = lambda: CE.ce_rows(logits, tgt, mask, True)  # noqa: E731  (dlog in place each call)
    r["ms"], r["device_ms"] = _median_ms(call, reps=5, batch=3), _device_ms(call, n=5)
    r["plain_ms"] = _median_ms(lambda: CE.ce_rows_plain(logits, tgt, mask, True), reps=3, batch=1)
    x = logits.clone().requires_grad_()
    r["cross_entropy_fwd_bwd_ms"] = _median_ms(lambda: torch.autograd.grad(
        (F.cross_entropy(x, tgt, reduction="none") * mask).sum(), x), reps=3, batch=1)
    del x
    # one read of the unmasked rows, one write of every row's dlog
    unmasked = int((mask != 0).sum())
    r["bound_ms"], r["bound_by"] = _bound((unmasked + rows) * V * 4 + _nbytes(tgt, mask) + rows * 4,
                                          0)
    if _TIMED:
        print(f"  CE-row [{rows}, {V}] with the gradient: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}); F.cross_entropy forward + backward "
              f"{r['cross_entropy_fwd_bwd_ms']:.4f} ms (timed only)")
    del logits
    torch.cuda.empty_cache()
    return r


@contextlib.contextmanager
def _plain_train():
    """Bind the plain versions where training calls its kernels: the
    decoder's attention (`train_attention_plain`, autograd through plain
    ops, 512-row blocks at T >= 2048) and the fused CE's row pass
    (`ce_rows_plain`). Phase 4's reference; the trainer has no such route."""
    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops import linear_ce as CE
    from streaming_vlm_tpu_torch.train import step as S

    kernels = lang.train_attention, S.ce_rows
    lang.train_attention, S.ce_rows = A.train_attention_plain, CE.ce_rows_plain
    try:
        yield
    finally:
        lang.train_attention, S.ce_rows = kernels


def phase_train_reference(cfg) -> dict:
    """sft_loss at the config's widths with the decoder cut to REF_LAYERS
    layers, T = TRAIN_REF_T, random bf16 weights: the loss and its text
    gradients through the kernels (K1 with its log-sum-exp, K1-bwd, CE-row)
    against the same loss through the plain path in f32 on the card (the
    same weights, cast), as the loss's relative error and each gradient
    leaf's relative L2 error, each within its limit (TRAIN_LOSS_TOL,
    TRAIN_GRAD_TOL) or within REF_NOISE_FACTOR times the plain path's own
    error in bf16 (the noise floor). Checks the kernels' launches."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.train import step as S

    tcfg = dataclasses.replace(cfg.text, num_hidden_layers=REF_LAYERS)
    rcfg = dataclasses.replace(cfg, text=tcfg)
    model = init_params(rcfg, torch.Generator(device="cuda").manual_seed(3), device="cuda",
                        dtype=torch.bfloat16)
    T, D = TRAIN_REF_T, tcfg.hidden_size
    n_vis = T // 8
    rng = np.random.default_rng(11)
    ids = rng.integers(0, tcfg.vocab_size, (1, T))
    labels = ids.copy()
    labels[:, : 2 * T // 5] = -100
    slots = np.sort(rng.choice(2 * T // 5, n_vis, replace=False))[None]
    slots[:, -2:] = T  # dropped
    batch = {"input_ids": torch.from_numpy(ids).cuda(), "labels": torch.from_numpy(labels).cuda(),
             "positions": torch.arange(T, dtype=torch.float32, device="cuda").expand(1, 3, T)
             .contiguous(),
             "vis_embeds": (torch.from_numpy(rng.standard_normal((1, n_vis, D))).float() * 0.02)
             .cuda(),
             "vis_slots": torch.from_numpy(slots).cuda()}

    def loss_and_grads(m, dtype):
        params = S.trained_params(m)
        b = dict(batch, vis_embeds=batch["vis_embeds"].to(dtype))
        loss, count = S.sft_loss(rcfg, m, b)
        grads = torch.autograd.grad(loss, params)
        names = [n for n, _ in m.text.named_parameters()]
        return float(loss), int(count), dict(zip(names, (x.float() for x in grads)))

    _reset_counts()
    loss, count, grads = loss_and_grads(model, torch.bfloat16)
    torch.cuda.synchronize()
    launched = _counts()
    with _plain_train():
        loss16, _, grads16 = loss_and_grads(model, torch.bfloat16)
        model32 = copy.deepcopy(model).float()
        del model
        torch.cuda.empty_cache()
        loss32, _, grads32 = loss_and_grads(model32, torch.float32)
    del model32
    expect = {"streaming_prefill_attention": REF_LAYERS, "attention_bwd": REF_LAYERS,
              "ce_rows": -(-(T - 1) // S.FUSED_CE_CHUNK)}
    got = {k: launched[k] for k in expect}
    if got != expect:
        raise AssertionError(f"training forward + backward: launches {got}, expected {expect}")

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    leaf = {n: (rel_l2(grads[n], grads32[n]), rel_l2(grads16[n], grads32[n])) for n in grads32}
    worst = max(leaf, key=lambda n: leaf[n][0])
    r = dict(T=T, layers=REF_LAYERS, labeled_tokens=count, noise={n: v[1] for n, v in leaf.items()},
             loss_rel_err=abs(loss - loss32) / abs(loss32),
             loss_rel_err_plain_bf16=abs(loss16 - loss32) / abs(loss32),
             grad_rel_l2_max=leaf[worst][0], grad_rel_l2_max_leaf=worst,
             grad_rel_l2_plain_bf16_max=max(v[1] for v in leaf.values()), launches=got)
    ok = (r["loss_rel_err"] <= max(TRAIN_LOSS_TOL, REF_NOISE_FACTOR * r["loss_rel_err_plain_bf16"])
          and all(a <= max(TRAIN_GRAD_TOL, REF_NOISE_FACTOR * b) for a, b in leaf.values()))
    print(f"  sft_loss, {REF_LAYERS} layers, T={T}, {count} labeled tokens: loss {loss:.6f} "
          f"(kernels, bf16) vs {loss32:.6f} (plain, f32): rel err {r['loss_rel_err']:.3e} "
          f"(plain bf16 {r['loss_rel_err_plain_bf16']:.3e}; limit {TRAIN_LOSS_TOL} or "
          f"{REF_NOISE_FACTOR} x plain bf16); text gradients, rel L2 err by leaf (kernels / plain "
          f"bf16; limit {TRAIN_GRAD_TOL} or {REF_NOISE_FACTOR} x plain bf16):")
    for n, (a, b) in leaf.items():
        print(f"    {n}: {a:.3e} / {b:.3e}")
    print(f"  launches {got} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training gradients through the kernels disagree with the plain path")
    torch.cuda.empty_cache()
    return r


class _RawClip:
    """A clip of raw uint8 RGB frames in a .npz (`frames` [n, H, W, 3],
    `fps`) with what ChunkedVideoSource reads of ingest's VideoReader: frame
    i spans [i / fps, (i + 1) / fps), and `fetch` returns frames at the
    clip's own size (it refuses a resize)."""

    def __init__(self, path: str):
        import numpy as np

        with np.load(path) as z:
            self._frames = z["frames"]
            fps = float(z["fps"])
        self.n_frames, self.height, self.width = (int(d) for d in self._frames.shape[:3])
        self.avg_fps = fps
        i = np.arange(self.n_frames, dtype=np.float64)
        self.frame_ts = np.stack([i / fps, (i + 1) / fps], -1)

    def close(self) -> None:
        pass

    def fetch(self, indices, out_w: int, out_h: int):
        import numpy as np

        if (out_w, out_h) != (self.width, self.height):
            raise ValueError(f"a raw clip is read at its own size {self.width}x{self.height}, "
                             f"not {out_w}x{out_h}")
        return self._frames[np.asarray(indices, np.int64)]


@contextlib.contextmanager
def _raw_clips():
    """Bind `_RawClip` in place of ingest's VideoReader for slices M and N:
    the card's machine has no FFmpeg libraries, so their clips are raw
    frames."""
    from streaming_vlm_tpu_torch.video import ingest

    reader = ingest.VideoReader
    ingest.VideoReader = _RawClip
    try:
        yield
    finally:
        ingest.VideoReader = reader


def _train_annotation(root: Path, h: int, w: int, seconds: int, fps: int) -> str:
    """A raw clip (a moving gradient, `_RawClip`'s .npz) and a jsonl of one
    example over it: one phrase a second, a qa question at 2-3 s."""
    clip = _clip(root / "clip.npz", h, w, seconds, fps)
    text_stream = [[i + 0.1, i + 0.8, f"phrase {i} of the stream"] for i in range(seconds)]
    conv = [
        {"role": "user", "content": [{"type": "video", "video": str(clip), "video_start": 0.0,
                                      "video_end": float(seconds), "previous": "earlier words"}]},
        {"role": "assistant", "content": [{"type": "text", "text_stream": text_stream,
                                           "qa_stream": [[2.0, 3.0, " What moves?",
                                                          "A gradient."]]}]},
    ]
    ann = root / "train.jsonl"
    ann.write_text(json.dumps(conv) + "\n")
    return str(ann)


def phase_train(cfg) -> tuple:
    """Slice M: the Trainer at the config's widths with the decoder cut to
    TRAIN_LAYERS layers (embed, lm_head and the frozen vision tower whole),
    random bf16 weights, over a StreamDataset of one synthetic 476x840 clip
    (TRAIN_CLIP s): grad_accum 2, max_steps 2 (4 micro-steps), remat
    "full", prefetch 2, no save. Asserts finite losses and gradient norms,
    labeled tokens, and every attention through K1 (twice a layer a
    micro-step: remat) and K1-bwd, CE-row once a 2048-row chunk. Prints the
    micro-step time, tokens/s, the peak memory beside the reckoned one, and
    K1-bwd's and CE-row's device time a call (one more micro-step, traced).
    Returns (launch counts, stats)."""
    import shutil

    import torch

    from streaming_vlm_tpu_torch.data.dataset import StreamDataset
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.train import step as S
    from streaming_vlm_tpu_torch.train.trainer import TrainConfig, Trainer

    L = TRAIN_LAYERS
    mcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=L))
    t0 = time.perf_counter()
    model = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        dtype=torch.bfloat16)
    root = REPO / "build" / "slice_m"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ds = StreamDataset([_train_annotation(root, 476, 840, TRAIN_CLIP, TRAIN_CLIP_FPS)], cfg=mcfg,
                       encode=FakeTokenizer(mcfg.tokens))
    ex = ds[0]
    tc = TrainConfig(output_dir=str(root / "run"), grad_accum=2, max_steps=2, remat="full",
                     prefetch=2, save_steps=10**9, warmup_steps=1,
                     vis_buckets=TrainConfig().vis_buckets + (8192,))
    tr = Trainer(mcfg, model, tc)
    t_pad = tr._prepare_batch(ex)["input_ids"].shape[1]
    n_text = sum(p.numel() for p in model.text.parameters())
    print(f"  {mcfg.name}, {L} layers: {n_text / 1e9:.3f} B text parameters + the frozen tower, "
          f"random bf16, in {time.perf_counter() - t0:.2f} s; the example: {len(ex.input_ids)} "
          f"tokens ({len(ex.vision_slots)} vision, {int((ex.labels != -100).sum())} labeled, "
          f"{len(ex.frames)} turns) -> bucket {t_pad}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tr.train(ds, resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    rows = [json.loads(x) for x in (root / "run" / "metrics.jsonl").read_text().splitlines()]
    micro = len(rows)
    chunks = -(-(t_pad - 1) // S.FUSED_CE_CHUNK)
    expect = {"streaming_prefill_attention": 2 * L * micro, "attention_bwd": L * micro,
              "ce_rows": chunks * micro}
    got = {k: counts[k] for k in expect}
    for rw in rows:
        print(f"    step {rw['step']} (opt_step {rw['opt_step']}): loss {rw['loss']:.6f}, grad_norm "
              f"{rw['grad_norm']:.6f}, labeled {rw['labeled_tokens']}, {rw['step_time'] * 1e3:.1f} ms")
    ok = (micro == 4 and all(math.isfinite(rw["loss"]) and math.isfinite(rw["grad_norm"])
                             and rw["labeled_tokens"] > 0 for rw in rows) and got == expect)
    # K1-bwd's and CE-row's device time a call: one more micro-step, traced
    batch = tr._prepare_batch(ex)
    with _profiler() as prof:
        loss, _ = S.sft_loss(mcfg, model, batch, remat="full")
        torch.autograd.grad(loss, tr.params)
        torch.cuda.synchronize()
    dev_ms, by_kernel = {}, []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and t > 0:
            by_kernel.append((t / 1e3, e.count, e.key))
            for key, part in (("attention_bwd", "attn_bwd_"), ("ce_rows", "ce_rows_kernel")):
                if part in e.key:
                    dev_ms[key] = dev_ms.get(key, 0.0) + t / 1e3
    by_kernel.sort(reverse=True)
    print(f"  one more micro-step, traced (no optimizer update): device busy "
          f"{sum(r[0] for r in by_kernel):.1f} ms; by kernel:")
    for ms, n, key in by_kernel[:10]:
        print(f"    {ms:10.3f} ms {n:6d} calls  {key[:110]}")
    step_ms = [rw["step_time"] * 1e3 for rw in rows]
    p50_s, n_labeled = statistics.median(step_ms) / 1e3, int((ex.labels != -100).sum())
    # the text's parameters, gradients, MultiSteps' mean, mu, nu and the
    # boundary's update list in bf16, the frozen tower, the fused CE's
    # transients (an f32 logits chunk, its bf16 copy, the f32 dW) and
    # K1-bwd's scratch (f32 dQ accumulator and row records at the bucket)
    V, D = mcfg.text.vocab_size, mcfg.text.hidden_size
    n_tower = sum(p.numel() for p in model.vision.parameters())
    tc = mcfg.text
    bwd_scratch = sum(t.numel() * t.element_size() for t in A.attention_bwd_scratch(
        t_pad, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim, "meta"))
    reckoned = (n_text * 2 * 6 + n_tower * 2 + S.FUSED_CE_CHUNK * V * 6 + V * D * 4
                + bwd_scratch)
    stats = dict(layers=L, tokens=len(ex.input_ids), bucket=t_pad, micro_steps=micro,
                 wall_s=wall, micro_step_ms=step_ms, micro_step_p50_ms=statistics.median(step_ms),
                 labeled=n_labeled, tokens_per_s=len(ex.input_ids) / p50_s,
                 labeled_tokens_per_s=n_labeled / p50_s, bucket_tokens_per_s=t_pad / p50_s,
                 max_memory_allocated=peak, reckoned_bytes=reckoned,
                 attention_bwd_device_ms_a_call=dev_ms.get("attention_bwd", 0.0) / L,
                 ce_rows_device_ms_a_call=dev_ms.get("ce_rows", 0.0) / chunks,
                 losses=[rw["loss"] for rw in rows], grad_norms=[rw["grad_norm"] for rw in rows],
                 launches=got)
    print(f"  slice M: {micro} micro-steps in {wall:.2f} s; micro-step p50 "
          f"{stats['micro_step_p50_ms']:.1f} ms; {stats['tokens_per_s']:.1f} tokens/s over the "
          f"example's {len(ex.input_ids)} tokens ({stats['labeled_tokens_per_s']:.1f} over its "
          f"{n_labeled} labeled, {stats['bucket_tokens_per_s']:.1f} over the {t_pad} bucket); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (reckoned {reckoned / 2**30:.2f} "
          f"GiB); device a call: K1-bwd {stats['attention_bwd_device_ms_a_call']:.4f} ms, CE-row "
          f"{stats['ce_rows_device_ms_a_call']:.4f} ms; launches {got} (expected {expect}) "
          f"{'ok' if ok else 'FAIL'}")
    del tr, model, batch, loss
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("slice M: a loss or gradient norm is not finite, no token is "
                             "labeled, or a kernel's launches are off")
    return counts, stats


def _narrow_cfg():
    """A narrow model the kernels accept (head_dim 128, G = 2): hidden 512, 4
    heads, 2 kv heads, 2 layers, vocab 4096, the tiny tower widened to 512
    out."""
    from streaming_vlm_tpu_torch.config import qwen25_vl_tiny

    base = qwen25_vl_tiny(vocab_size=4096)
    text = dataclasses.replace(base.text, hidden_size=512, intermediate_size=1024,
                               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                               head_dim=128, mrope_section=(16, 24, 24))
    return dataclasses.replace(base, text=text,
                               vision=dataclasses.replace(base.vision, out_hidden_size=512))


# slice N: the evaluation harnesses, the LiveCC baseline, the demo and the
# CLI on slice A's bf16 weights (all 28 layers), FakeTokenizer, raw-frame
# clips bound in place of ingest's reader (`_raw_clips`)
EVAL_MCQ_GRIDS = ((1, 34, 60), (1, 18, 32), None, (2, 18, 32), None, (1, 34, 60), (2, 16, 28),
                  None)
EVAL_VQA = dict(frames=8, new_tokens=8, h=252, w=448)
EVAL_INF_CHUNKS = (4, 2)  # infstream: the first run's chunks, then the resume's
EVAL_CHUNKS = 3  # the livesports generators', the demo's and each multi-stream lane's
EVAL_LANES = 2


def _clip(path: Path, h: int, w: int, seconds: int, fps: int) -> str:
    """A raw clip (`_RawClip`'s .npz) of a moving gradient."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w]
    frames = np.stack([np.stack([(x + y + 8 * i) & 0xFF, (64 + x // 2 + 4 * i) & 0xFF,
                                 (128 + y // 2) & 0xFF], -1) for i in range(seconds * fps)])
    with open(path, "wb") as f:
        np.savez(f, frames=frames.astype(np.uint8), fps=np.float64(fps))
    return str(path)


def _sse(url: str, timeout: float = 600.0) -> list:
    """The `data:` payloads of an SSE stream, up to its `done` event."""
    import urllib.request

    got = []
    with urllib.request.urlopen(url, timeout=timeout) as events:
        for raw in events:
            line = raw.decode().strip()
            if line == "event: done":
                break
            if line.startswith("data:"):
                got.append(json.loads(line[5:]))
    return got


# `python -m streaming_vlm_tpu_torch soak` (the CLI's defaults: random 3B
# W8A8 weights, 120 chunks; fewer do not fill the default previous-text sink
# and window, so the occupancy is not yet constant), then the process's
# launch counts
SOAK_RUN = (
    "import json, runpy, sys\n"
    "sys.argv = ['streaming_vlm_tpu_torch', 'soak']\n"
    "runpy.run_module('streaming_vlm_tpu_torch', run_name='__main__', alter_sys=True)\n"
    "from streaming_vlm_tpu_torch.ops import attention as A, quant as Q\n"
    "print('COUNTS ' + json.dumps({**A.launch_counts, **Q.launch_counts,\n"
    "      **{'int8_gemm/' + k: v for k, v in Q.path_counts.items()}}))\n"
)
SOAK_OUT = REPO / "build" / "soak_n.txt"


def start_soak() -> subprocess.Popen:
    """Slice N's CLI step, started early: it runs beside the mutant copies'
    checks and phase 4, which time nothing, and slice N waits for it."""
    SOAK_OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(SOAK_OUT, "w") as out:
        return subprocess.Popen([sys.executable, "-c", SOAK_RUN], cwd=REPO, stdout=out,
                                stderr=subprocess.STDOUT, text=True)


def phase_eval(cfg, model, soak: subprocess.Popen) -> tuple:
    """Slice N: the port's evaluation harnesses, baseline, demo and CLI at
    the config's widths on `model` (bf16), FakeTokenizer, raw clips: (1)
    `mcq_predict_batch` over 8 questions with mixed grids (K1 once a layer
    for the batch); (2) `VQAChat.generate` on an 8-frame video message, 8
    new tokens (K1 raw mode: the prefill, then each T = 1 step); (3)
    `infstream.generate_segments`, 4 chunks, then a resume for 2 more;
    (4) the livesports streaming and livecc generators, 3 chunks each; (5)
    `stream_segments` through a `LiveCaptionServer` on localhost to one SSE
    client, 3 chunks; (6) `MultiLiveCaptionServer`, 2 lanes x 3 rounds; each with
    launch counts reset before it: its attention through K1 (and K2 where
    it decodes) alone, no other kernel (bf16 weights). Then (7) `python -m
    streaming_vlm_tpu_torch soak`, the process `start_soak` began (random
    3B W8A8 weights, 120 chunks): exit 0, kv_constant, its attention
    through K1 and K2 alone and every W8A8 product through K5 (the count
    each forward and tower call makes). Returns (launch counts, stats)."""
    import shutil
    import threading

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.baselines.livecc import LiveCCConfig
    from streaming_vlm_tpu_torch.config import qwen25_vl_3b
    from streaming_vlm_tpu_torch.demo.app import LiveCaptionServer, SegmentFeed, stream_segments
    from streaming_vlm_tpu_torch.demo.multiapp import MultiLiveCaptionServer
    from streaming_vlm_tpu_torch.eval import infstream, livesports, mcq
    from streaming_vlm_tpu_torch.eval.vqa import VQAChat
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.video.ingest import patchify_frames

    L, v = cfg.text.num_hidden_layers, cfg.vision
    k1, k2 = "streaming_prefill_attention", "streaming_decode_attention_full"
    tok = FakeTokenizer(cfg.tokens)
    root = REPO / "build" / "slice_n"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    clip8 = _clip(root / "clip8.npz", 476, 840, 8, 2)  # the streaming chunks' 476x840
    clip_vqa = _clip(root / "vqa.npz", EVAL_VQA["h"], EVAL_VQA["w"], 4, 4)
    totals, times = dict.fromkeys(_counts(), 0), {}
    t_slice = time.perf_counter()

    def step(name, fn, kernels, k1_launches=None):
        """Run fn with counts reset: only `kernels` of the attention ones and
        each of them, no other kernel; K1 k1_launches times when given (a
        number, or a function of fn's result)."""
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        c = {k: n for k, n in _counts().items() if n}
        print(f"  N {name}: {times[name]:.2f} s, launches {c}")
        if callable(k1_launches):
            k1_launches = k1_launches(out)
        if set(c) != set(kernels) or (k1_launches is not None and c[k1] != k1_launches):
            raise AssertionError(f"slice N {name}: launches {c}, want {kernels}"
                                 + (f" with K1 {k1_launches} times" if k1_launches else ""))
        for k, n in c.items():
            totals[k] += n
        return out

    rng = np.random.default_rng(4)
    with _raw_clips():
        # (1) MCQ: 8 questions, 5 with a video crop each (4 grids), one pass
        opt = mcq.option_token_ids(tok, ["A", "B", "C", "D"])
        ids, patches, spg = [], [], []
        for i, g in enumerate(EVAL_MCQ_GRIDS):
            n_vis = 0 if g is None else int(np.prod(g)) // v.spatial_merge_unit
            ids.append(mcq.build_mcq_prompt_ids(cfg, tok, f"Question {i}: what happens?" * (i + 1),
                                                n_vis))
            if g is None:
                patches.append(None), spg.append(None)
                continue
            frames = rng.integers(0, 256, (g[0] * v.temporal_patch_size, g[1] * v.patch_size,
                                           g[2] * v.patch_size, 3), dtype=np.uint8)
            patches.append(patchify_frames(frames, patch_size=v.patch_size,
                                           temporal_patch_size=v.temporal_patch_size,
                                           merge_size=v.spatial_merge_size)[0])
            spg.append(1.0)
        picks = step("MCQ", lambda: mcq.mcq_predict_batch(
            cfg, model, ids, [opt] * len(ids), pixel_patches=patches,
            video_grid_thw=list(EVAL_MCQ_GRIDS), second_per_grid_ts=spg), (k1,), L)
        assert len(picks) == len(ids) and all(0 <= p < 4 for p in picks), picks

        # (2) VQA: 8 frames, 8 new tokens over the KV-cached raw arena: K1
        # for the prefill and for each T = 1 step (one fewer than the tokens,
        # or as many when <|im_end|> ended the answer early)
        n_new = EVAL_VQA["new_tokens"]
        chat = VQAChat(cfg, model, tok, lambda out: out, max_new_tokens=n_new,
                       nframe=EVAL_VQA["frames"])
        gen = step("VQA", lambda: chat.generate(
            [{"type": "video", "value": clip_vqa},
             {"type": "text", "value": "What moves in the video?"}]), (k1,),
            lambda out: L * (1 + (len(out) - 1 if len(out) == n_new else len(out))))
        assert len(gen) <= n_new, gen

        # (3) Inf-Stream-Eval: 4 chunks, then a resume for 2 more
        meta_part, meta = root / "part.jsonl", root / "meta.jsonl"
        n_words = 2 * sum(EVAL_INF_CHUNKS)  # 0.5 s each
        content = [[i * 0.5, i * 0.5 + 0.5, f"w{i}"] for i in range(n_words)]
        meta_part.write_text(json.dumps(
            {"video": clip8, "content": content[:2 * EVAL_INF_CHUNKS[0]]}) + "\n")
        meta.write_text(json.dumps({"video": clip8, "content": content}) + "\n")
        out = root / "inf.jsonl"
        for m, n in zip((meta_part, meta), EVAL_INF_CHUNKS):
            step(f"infstream {n} chunks", lambda m=m: infstream.generate_segments(
                cfg=cfg, model=model, tokenizer=tok, eval_metadata=str(m), out_path=str(out),
                start_time=0), (k1, k2), L * n)
        lines = [json.loads(x) for x in out.read_text().splitlines()]
        n0 = EVAL_INF_CHUNKS[0]
        assert [(x["chunk_start"], x["chunk_end"]) for x in lines] == [
            (0, n0), (n0, sum(EVAL_INF_CHUNKS))], lines

        # (4) LiveSports: the streaming and the livecc generators, 3 chunks each
        ev = {"event_id": "n1", "video": clip8, "begin": 0.0, "preasr_text": "earlier words",
              "event_cc": "baseline", "title": "Final"}
        lc = LiveCCConfig()
        for name, end, gen_fn in (
                ("livesports streaming", float(EVAL_CHUNKS), livesports.generate_commentary),
                # LiveCC's clips: initial_fps_frames, then streaming_fps_frames each
                ("livesports livecc", (lc.initial_fps_frames + (EVAL_CHUNKS - 1)
                                       * lc.streaming_fps_frames) / lc.fps,
                 livesports.generate_livecc_commentary)):
            events = root / f"{name.split()[1]}.jsonl"
            events.write_text(json.dumps({**ev, "end": end}) + "\n")
            written = step(name, lambda e=events, f=gen_fn: f(
                cfg=cfg, model=model, tokenizer=tok, events_path=str(e),
                out_dir=str(root / e.stem)), (k1, k2), L * EVAL_CHUNKS)
            assert len(written) == 1 and json.loads(Path(written[0]).read_text())["pred"]

        # (5) the demo: stream_segments -> a feed -> one SSE client over HTTP
        def demo():
            feed = SegmentFeed()

            def produce():
                try:
                    for seg in stream_segments(cfg=cfg, model=model, tokenizer=tok,
                                               video_path=clip8, duration=float(EVAL_CHUNKS)):
                        feed.push(seg)
                finally:
                    feed.finish()

            srv = LiveCaptionServer(clip8, feed.subscribe, port=0)
            srv.start_background()
            th = threading.Thread(target=produce, daemon=True)
            th.start()
            try:
                return _sse(f"http://127.0.0.1:{srv.port}/events")
            finally:
                th.join()
                srv.shutdown()

        segs = step("demo", demo, (k1, k2), L * EVAL_CHUNKS)
        assert [s["start"] for s in segs] == [float(i) for i in range(EVAL_CHUNKS)], segs

        # (6) the multi-stream demo: 2 lanes x 3 rounds on one card
        def multi():
            srv = MultiLiveCaptionServer(cfg, model, tok, [clip8] * EVAL_LANES,
                                         duration=float(EVAL_CHUNKS), port=0)
            srv.start_background()
            try:
                got = [_sse(f"http://127.0.0.1:{srv.port}/events/{i}") for i in range(EVAL_LANES)]
                assert srv.wait(timeout=600.0)
                return got
            finally:
                srv.shutdown()

        lanes = step("multiapp", multi, (k1, k2))
        assert [len(x) for x in lanes] == [EVAL_CHUNKS] * EVAL_LANES, lanes

    # (7) the CLI: soak on random 3B W8A8 weights, a process of its own
    t0 = time.perf_counter()
    rc = soak.wait(timeout=900)
    times["soak wait"] = time.perf_counter() - t0
    text = SOAK_OUT.read_text()
    if rc != 0:
        print(text[-6000:])
        raise AssertionError(f"soak exited {rc}")
    report = json.loads(next(x for x in text.splitlines() if x.startswith("{")))
    c = {k: n for k, n in json.loads(text.split("COUNTS ", 1)[1]).items() if n}
    c3 = qwen25_vl_3b()
    L3 = c3.text.num_hidden_layers
    forwards = (c.get(k1, 0) + c.get(k2, 0)) / L3  # each prefill and decode step: once a layer
    k5 = (7 * L3 + 1) * forwards + report["n_chunks"] * (5 * c3.vision.depth + 2)
    print(f"  N soak (python -m streaming_vlm_tpu_torch soak, {report['n_chunks']} chunks, beside "
          f"the mutants' checks and phase 4: its times are not measurements): waited "
          f"{times['soak wait']:.2f} s, kv_constant {report['kv_constant']}, occupancy "
          f"{report['kv_occupancy']}, launches {c} (K5: {k5:.0f} products expected)")
    attn = {k for k in c if k in A.launch_counts}
    if not report["kv_constant"] or attn != {k1, k2} or c.get("int8_gemm") != k5 \
            or c["int8_gemm"] != c.get("int8_gemm/gemv", 0) + c.get("int8_gemm/tiled", 0):
        raise AssertionError(f"soak: kv_constant {report['kv_constant']}, launches {c}")
    for k, n in c.items():
        totals[k] += n
    # the multi-stream server's engines sit in reference cycles: their
    # arenas go back to the allocator now, not at some later collection
    # inside another slice
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_slice
    print(f"  slice N: {wall:.1f} s ({', '.join(f'{k} {t:.1f}' for k, t in times.items())})")
    shutil.rmtree(root, ignore_errors=True)
    return totals, dict(wall_s=wall, step_s=times, soak=dict(
        n_chunks=report["n_chunks"], kv_constant=report["kv_constant"],
        kv_occupancy=report["kv_occupancy"]))


def phase_train_resume() -> dict:
    """The Trainer's resume and prefetch on the card, bitwise, at
    `_narrow_cfg`'s widths (bf16, K1 / K1-bwd / CE-row), grad_accum 2: 6
    micro-steps straight through (prefetch 2), against 4 that save at each
    optimizer boundary (2 and 4; the first update runs at lr 0, so the
    parameters first move at 4), then a fresh Trainer and model resuming
    from checkpoint-4 for the last 2 (prefetch 0). The final parameters
    must be equal bit for bit, and differ from the initial ones."""
    import shutil

    import torch

    from streaming_vlm_tpu_torch.config import VideoConfig
    from streaming_vlm_tpu_torch.data.dataset import StreamDataset
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = _narrow_cfg()
    root = REPO / "build" / "slice_m_resume"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ds = StreamDataset([_train_annotation(root, 56, 56, 4, 4)], cfg=cfg,
                       encode=FakeTokenizer(cfg.tokens),
                       video=VideoConfig(video_min_pixels=28 * 28, video_max_pixels=4 * 28 * 28))
    kw = dict(grad_accum=2, learning_rate=1e-3, warmup_steps=1, seq_buckets=(256, 512),
              vis_buckets=(64,), remat="full")

    def run(name, max_steps, prefetch, resume):
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(5), device="cuda",
                            dtype=torch.bfloat16)
        tr = Trainer(cfg, model, TrainConfig(output_dir=str(root / name), max_steps=max_steps,
                                             save_steps=1, prefetch=prefetch, **kw))
        tr.train(ds, resume=resume)
        return tr

    straight = run("straight", 3, 2, False)
    run("resumed", 2, 0, False)
    resumed = run("resumed", 3, 0, True)
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    init = init_params(cfg, torch.Generator(device="cuda").manual_seed(5), device="cuda",
                       dtype=torch.bfloat16).state_dict()
    moved = sum(not torch.equal(a[k], init[k]) for k in a)
    losses = [json.loads(x)["loss"] for x in (root / "straight" / "metrics.jsonl").read_text()
              .splitlines()]
    r = dict(micro_steps=straight.step, resumed_at=4, tensors=len(a), moved=moved, differ=differ,
             losses=losses)
    ok = not differ and straight.step == resumed.step == 6 and moved > 0
    print(f"  resume check ({cfg.text.hidden_size} wide, {cfg.text.num_hidden_layers} layers, "
          f"vocab {cfg.text.vocab_size}): 6 micro-steps straight (prefetch 2) against 4 + resume "
          f"+ 2 (prefetch 0): {len(a) - len(differ)} of {len(a)} tensors bitwise equal ({moved} "
          f"moved by training); losses {losses} {'ok' if ok else 'FAIL'}")
    shutil.rmtree(root, ignore_errors=True)
    if not ok:
        raise AssertionError(f"resume: the resumed run's parameters differ: {differ[:8]}")
    return r


# ---- slice O: the parallel modes (parallel/), two ranks on the one card
# over gloo (NCCL refuses two ranks on one device), then a one-rank NCCL
# world. 7B widths, the decoder cut to PAR_LAYERS layers and the tower to
# PAR_BLOCKS blocks. No speed is claimed: the ranks share the card's SMs and
# memory, and gloo's hops go through the host.
PAR_LAYERS, PAR_BLOCKS = 4, 4
PAR_CHUNKS = 6  # O1: window_size PAR_WINDOW puts the evictions in the last two
PAR_WINDOW = 4
PAR_MAX_NEW = 8  # O1, O2, O6: tokens a chunk (every decode step is ~5 collectives a layer)
PAR_ROUNDS = 4  # O2
SP_T, PP_T, DP_T = 8192, 4096, 1024  # O3, O4 (a microbatch), O5
# O1: chunk 0's logits of B's config (bf16 weights, raw int8 arena, K1 +
# K3) under {"model": 2} against the unsharded engine's in one process, max
# |diff| over the largest |logit|. The TP path differs from the unsharded
# one only in its sums: o and down are row-parallel (two bf16 partials
# summed after each is rounded), and K1 / K3 run plans cut for Hkv / tp kv
# heads; bf16 activations carry no requantization, so that floor stays
# near bf16 rounding. A planted fault reads it against the same engine with
# layer 0's kv heads swapped between the ranks (_swap_kv_heads). On an
# NVIDIA H100 80GB HBM3 at 700 W (tools/parallel_torch.py) the sound
# reading is 1.650e-2 (the unsharded bf16 forward's own distance from the
# f32 oracle is ~2e-2, phase 4) and the fault's 1.275; the limit is 1.9x
# the one and 1/41 of the other.
PAR_LOGIT_TOL = 2.0**-5
# O1's and O2's W8A8 logits (C's config; O2's engines) against the
# unsharded engine's: a loose sanity bound only. Every W8A8 product under TP
# is bitwise the unsharded one (tests/test_torch_parallel_serve.py), but
# random W8A8 weights requantize every activation row to int8, so an ulp of
# the attention (another kv-head or lane plan) grows through 4 layers to
# ~5e-2 of the largest logit: O2's data=2 case, whose only change is K1's
# lane plan, read 4.97e-2 on an NVIDIA H100 80GB HBM3 at 700 W
# (this script). Wrong splits are caught by the bf16 limit above.
PAR_W8A8_LOGIT_TOL = 2.0**-3
PAR_TIMEOUT = 600.0  # seconds for the world's parts


def _par_cfg(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=PAR_LAYERS),
        vision=dataclasses.replace(cfg.vision, depth=PAR_BLOCKS))


def _par_w8a8(cfg):
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl.model import random_quantized_model

    return random_quantized_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")


def _par_bf16(cfg, seed: int = 3):
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params

    return init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda",
                       dtype=torch.bfloat16)


class _FirstLogits:
    """Records the first lm_logits call's output (a chunk's or round's
    prefill) while active."""

    def __enter__(self):
        from streaming_vlm_tpu_torch.models.qwen25_vl import language

        self.lang, self.real, self.logits = language, language.lm_logits, None

        def spy(cfg, lm, hidden):
            out = self.real(cfg, lm, hidden)
            if self.logits is None:
                self.logits = out.detach().float().clone()
            return out

        language.lm_logits = spy
        return self

    def __exit__(self, *exc):
        self.lang.lm_logits = self.real


def _host_state(e) -> tuple:
    """An engine's host accounting, as comparable values."""
    import hashlib

    import numpy as np

    ids = np.asarray(e.table.token_ids())
    pos = np.ascontiguousarray(e._positions()[:, : e.cached], np.float32)
    return (hashlib.sha1(ids.tobytes()).hexdigest(), int(e.cached), int(e.uncached_tail),
            hashlib.sha1(pos.tobytes()).hexdigest())


def _par_chunks(cfg, eng, n, rng, expect=None, logits=False):
    """n chunks of bench.py's client stream through eng.process_chunk:
    (per chunk (tokens, host state), chunk 0's prefill logits when
    `logits`, per chunk whether it evicted, the launches summed); each
    chunk's launches checked against `expect` (per chunk) when given."""
    import torch

    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer, PromptBuilder

    import collections

    b = PromptBuilder(cfg.tokens, FakeTokenizer(cfg.tokens))
    _, end_bias = b.measure_biases()
    out, first, evicted, total = [], None, [], collections.Counter()
    for i, (px, grid) in enumerate(_patches(cfg, rng, n)):
        _reset_counts()
        with _FirstLogits() as fl:
            g, _ = eng.process_chunk(_client_segs(cfg, b, i, "What is happening?", grid), px,
                                     grid)
        torch.cuda.synchronize()
        got = _counts()
        total.update(got)
        if expect is not None:
            want = {k: expect.get(k, 0) for k in got}
            if got != want:
                raise AssertionError(f"chunk {i}: launches {got}, single-card path {want}")
        if i == 0 and logits:
            first = fl.logits.cpu()
        eng.commit_assistant(g, end_bias, i)
        evicted.append(eng.cached_after_evict < eng.cached_before_evict)
        out.append((g.tolist(), _host_state(eng)))
    return out, first, evicted, total


def _swap_kv_heads(model, mesh, layer: int = 0) -> None:
    """A planted tensor-parallel fault: layer `layer`'s k and v projections
    of each rank take the other rank's kv heads (a wrong kv-head slice)."""
    import torch

    from streaming_vlm_tpu_torch.parallel.distributed import all_gather

    g, r = mesh.group("model"), mesh.index("model")
    lyr = model.text.layers[layer]
    with torch.no_grad():
        for lin in (lyr.k_proj, lyr.v_proj):
            for p in (lin.weight, lin.bias):
                if p is not None:
                    p.copy_(all_gather(p, g, 0).chunk(2)[1 - r])


def _rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _par_o1(cfg, mesh_model, expect_c, expect_b):
    """O1 on one rank: slice C's config under {"model": 2} for PAR_CHUNKS
    chunks (launches per chunk checked), chunk 0's logits against the
    unsharded engine on the same weights (a loose bound); then 2 chunks of
    B's config (bf16), chunk 0's logits against the unsharded engine's (the
    tight bound), and again with layer 0's kv heads swapped between the
    ranks (the planted fault, which must read above it)."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import SamplingConfig, StreamConfig
    from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

    greedy = SamplingConfig(do_sample=False)
    stream_c = StreamConfig(kv_quant="int8", window_size=PAR_WINDOW, text_round=PAR_WINDOW,
                            max_tokens_per_chunk=PAR_MAX_NEW)
    model = _par_w8a8(cfg)
    ref = StreamingEngine(cfg, model, stream_c, greedy)  # the same weights, before the cut
    ref_logits = _par_chunks(cfg, ref, 1, np.random.default_rng(0), logits=True)[1]
    del ref
    torch.cuda.empty_cache()
    eng = StreamingEngine(cfg, model, stream_c, greedy, mesh=mesh_model)
    c, logits, evicted, counts = _par_chunks(cfg, eng, PAR_CHUNKS, np.random.default_rng(0),
                                             expect_c, logits=True)
    w8a8_err = _rel_err(logits, ref_logits)
    del eng, model
    torch.cuda.empty_cache()
    stream_b = StreamConfig(kv_quant="int8", prerotate_arena=False,
                            max_tokens_per_chunk=PAR_MAX_NEW)
    model = _par_bf16(cfg)
    ref = StreamingEngine(cfg, model, stream_b, greedy)  # before the cut
    ref_logits = _par_chunks(cfg, ref, 1, np.random.default_rng(1), logits=True)[1]
    del ref
    eng = StreamingEngine(cfg, model, stream_b, greedy, mesh=mesh_model)
    b, logits, _, counts_b = _par_chunks(cfg, eng, 2, np.random.default_rng(1), expect_b,
                                         logits=True)
    del eng
    _swap_kv_heads(model, mesh_model)
    eng = StreamingEngine(cfg, model, stream_b, greedy, mesh=mesh_model)
    fault = _par_chunks(cfg, eng, 1, np.random.default_rng(1), logits=True)[1]
    del eng, model
    torch.cuda.empty_cache()
    return dict(c=c, b=b, evicted=evicted, w8a8_logit_rel_err=w8a8_err,
                logit_rel_err=_rel_err(logits, ref_logits),
                fault_logit_rel_err=_rel_err(fault, ref_logits), counts=counts + counts_b)


def _par_o2(cfg, mesh_data, mesh_model):
    """O2 on one rank: MultiStreamEngine on {"data": 2} with 4 lanes (2 a
    rank), then on {"model": 2} with 2 lanes, PAR_ROUNDS rounds each
    (sampled): every lane's host state after each round, and round 0's
    logits of this rank's lanes against the single-card engine's."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import SamplingConfig, StreamConfig
    from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer, PromptBuilder

    import collections

    stream = StreamConfig(kv_quant="int8", max_tokens_per_chunk=PAR_MAX_NEW)
    sampling = SamplingConfig()
    out, counts = {}, collections.Counter()
    for tag, mesh, B in (("data", mesh_data, 4), ("model", mesh_model, 2)):
        def rounds(ms, n):
            b = PromptBuilder(cfg.tokens, FakeTokenizer(cfg.tokens))
            _, end_bias = b.measure_biases()
            rng, states, first = np.random.default_rng(2), [], None
            for r in range(n):
                pats = _patches(cfg, rng, B)
                grid = pats[0][1]
                segs = [_client_segs(cfg, b, r, f"lane {i}?", grid) for i in range(B)]
                with _FirstLogits() as fl:
                    ve = ms.encode_round(np.stack([p for p, _ in pats]), grid)
                    res = ms.process_round(segs, vis_embeds=ve, grid_thw=grid)
                if first is None:
                    first = fl.logits.cpu()
                ms.commit_assistant([g for g, _ in res], end_bias, r)
                states.append([(g.tolist(), _host_state(e)) for (g, _), e in zip(res, ms.engines)])
            return states, first

        model = _par_w8a8(cfg)
        ms = MultiStreamEngine(cfg, model, stream, sampling, n_streams=B, mesh=mesh)
        _reset_counts()
        states, first = rounds(ms, PAR_ROUNDS)
        torch.cuda.synchronize()
        counts.update(_counts())
        lo, hi = ms.lo, ms.hi
        del ms
        if tag == "model":
            del model
            torch.cuda.empty_cache()
            model = _par_w8a8(cfg)
        ref = MultiStreamEngine(cfg, model, stream, sampling, n_streams=B)
        _, ref_first = rounds(ref, 1)
        del ref, model
        torch.cuda.empty_cache()
        ref_first = ref_first[lo:hi]
        out[tag] = dict(states=states, lanes=(lo, hi), logit_rel_err=_rel_err(first, ref_first))
    out["counts"] = counts
    return out


def _par_batch(cfg, B: int, T: int, seed: int):
    """A training batch at the decoder's widths: B examples of T tokens, the
    first 2/5 unlabeled, T // 8 vision rows scattered in (two past T,
    dropped)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    D, n_vis = cfg.text.hidden_size, T // 8
    ids = rng.integers(0, cfg.text.vocab_size, (B, T))
    labels = ids.copy()
    labels[:, : 2 * T // 5] = -100
    slots = np.stack([np.sort(rng.choice(2 * T // 5, n_vis, replace=False)) for _ in range(B)])
    slots[:, -2:] = T
    return {"input_ids": torch.from_numpy(ids).cuda(), "labels": torch.from_numpy(labels).cuda(),
            "positions": torch.arange(T, dtype=torch.float32, device="cuda").expand(B, 3, T)
            .contiguous(),
            "vis_embeds": (torch.from_numpy(rng.standard_normal((B, n_vis, D))).float() * 0.02)
            .to(torch.bfloat16).cuda(),
            "vis_slots": torch.from_numpy(slots).cuda()}


def _par_loss(cfg, mode, mesh, batch):
    """(loss, grads by parameter name, launches) of sft_loss_sp / _pp on
    `mesh`, or sft_loss (mode None) on one rank, fresh bf16 weights."""
    import torch

    from streaming_vlm_tpu_torch.parallel.pipeline import sft_loss_pp, split_stages
    from streaming_vlm_tpu_torch.parallel.ring import sft_loss_sp
    from streaming_vlm_tpu_torch.train import step as S

    model = _par_bf16(cfg)
    first = split_stages(cfg, model, mesh)[0] if mode == "pp" else 0
    params = S.trained_params(model)
    _reset_counts()
    if mode == "sp":
        loss, _ = sft_loss_sp(cfg, model, batch, mesh)
    elif mode == "pp":
        loss, _ = sft_loss_pp(cfg, model, batch, mesh)
    else:
        loss, _ = S.sft_loss(cfg, model, batch)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    launches = _counts()

    def name(n):  # a stage's layer i is the model's layer first + i
        if n.startswith("layers."):
            i, rest = n[len("layers."):].split(".", 1)
            return f"layers.{first + int(i)}.{rest}"
        return n

    out = {name(n): g.float() for (n, _), g in zip(model.text.named_parameters(), grads)}
    del model, params, grads
    torch.cuda.empty_cache()
    return float(loss.detach()), out, launches


def _par_train_cmp(got: dict, ref: dict, noise: dict) -> tuple:
    """(worst leaf, its rel L2 error, whether every leaf of `got` is within
    max(TRAIN_GRAD_TOL, REF_NOISE_FACTOR * noise[leaf]))."""
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    errs = {n: rel(g, ref[n]) for n, g in got.items()}
    worst = max(errs, key=errs.get)
    ok = all(e <= max(TRAIN_GRAD_TOL, REF_NOISE_FACTOR * noise.get(n, 0.0)) for n, e in errs.items())
    return worst, errs[worst], ok


def _par_o3(cfg, mesh_seq, noise):
    """O3: sft_loss_sp at T = SP_T over {"seq": 2} against the one-card
    sft_loss on the same weights and batch (rank 0 runs it after)."""
    import torch

    batch = _par_batch(cfg, 1, SP_T, 5)
    loss, grads, launches = _par_loss(cfg, "sp", mesh_seq, batch)
    r = dict(loss=loss, launches={k: launches[k] for k in ("full_block_attention",
                                                            "attention_bwd_full",
                                                            "streaming_prefill_attention",
                                                            "attention_bwd", "ce_rows")},
             counts=launches)
    if mesh_seq.rank == 0:
        ref_loss, ref, _ = _par_loss(cfg, None, None, batch)
        worst, err, ok = _par_train_cmp(grads, ref, noise)
        r.update(ref_loss=ref_loss, loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
                 grad_worst_leaf=worst, grad_rel_l2_max=err, grads_ok=ok)
        del ref
    del grads
    torch.cuda.empty_cache()
    return r


def _par_o4(cfg, mesh_stage, noise):
    """O4: sft_loss_pp over {"stage": 2} (2 layers a stage), 2 microbatches
    of PP_T, against the one-card sft_loss; the replicated parameters'
    gradients (embed, final_ln, lm_head) returned for the cross-rank check."""
    import torch

    batch = _par_batch(cfg, 2, PP_T, 6)
    loss, grads, launches = _par_loss(cfg, "pp", mesh_stage, batch)
    import hashlib

    rep = {n: hashlib.sha1(g.cpu().numpy().tobytes()).hexdigest() for n, g in grads.items()
           if not n.startswith("layers.")}
    r = dict(loss=loss, replicated=rep, counts=launches)
    ref_loss, ref, _ = _par_loss(cfg, None, None, batch)
    worst, err, ok = _par_train_cmp(grads, ref, noise)
    r.update(ref_loss=ref_loss, loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
             grad_worst_leaf=worst, grad_rel_l2_max=err, grads_ok=ok)
    del grads, ref
    torch.cuda.empty_cache()
    return r


def _par_o5(cfg, mesh_data, tmp: str):
    """O5: the Trainer in gspmd mode on {"data": 2}, 2 steps of B = 2
    examples of DP_T tokens, against the one-card Trainer on the same
    batches (rank 0 runs it after); each rank's AdamW moment bytes."""
    import torch

    from streaming_vlm_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = [_par_batch(cfg, 2, DP_T, 7 + i) for i in range(2)]

    def run(mesh, sub):
        tc = TrainConfig(output_dir=f"{tmp}/{sub}", max_steps=2, warmup_steps=1, grad_accum=1,
                         remat="none")
        tr = Trainer(cfg, _par_bf16(cfg), tc, mesh=mesh)
        _reset_counts()
        ms = [{k: float(v) for k, v in tr._train_step(b).items()} for b in batches]
        torch.cuda.synchronize()
        inner = tr.opt_state["inner"]
        moments = sum(t.numel() * t.element_size() for t in inner["mu"] + inner["nu"])
        counts = _counts()
        del tr
        torch.cuda.empty_cache()
        return ms, moments, counts

    metrics, moments, counts = run(mesh_data, f"rank{mesh_data.rank}")
    r = dict(metrics=metrics, moment_bytes=moments, counts=counts)
    if mesh_data.rank == 0:
        ref, ref_moments, _ = run(None, "one-card")
        r.update(ref_metrics=ref, ref_moment_bytes=ref_moments)
    return r


def _slice_o_rank(rank: int, init_file: str, args: tuple, q) -> None:
    """One rank of slice O's gloo world on cuda:0: O1-O5 in turn, each
    part's result, seconds and peak memory sent to the parent; any
    exception sent as the rank's failure."""
    import traceback
    from datetime import timedelta

    try:
        sys.path.insert(0, str(REPO))
        import torch
        import torch.distributed as dist

        from streaming_vlm_tpu_torch.parallel.mesh import make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=2, timeout=timedelta(seconds=PAR_TIMEOUT - 60))
        cfg, expect_c, expect_b, noise, tmp = args
        meshes = {a: make_mesh({a: 2}) for a in ("model", "data", "seq", "stage")}
        parts = (("O1", lambda: _par_o1(cfg, meshes["model"], expect_c, expect_b)),
                 ("O2", lambda: _par_o2(cfg, meshes["data"], meshes["model"])),
                 ("O3", lambda: _par_o3(cfg, meshes["seq"], noise)),
                 ("O4", lambda: _par_o4(cfg, meshes["stage"], noise)),
                 ("O5", lambda: _par_o5(cfg, meshes["data"], tmp)))
        out = {}
        for name, fn in parts:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out[name] = dict(r, seconds=time.perf_counter() - t0, backend=dist.get_backend(),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        q.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001  (the parent fails the run with it)
        q.put((rank, False, traceback.format_exc()))


def _par_o6(cfg, init_file: str) -> dict:
    """O6, in this process: a one-rank NCCL world, O1's W8A8 engine with
    mesh {"model": 1} for 2 chunks, its tokens against the engine with no
    mesh on the same weights (before the cut)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from streaming_vlm_tpu_torch.config import SamplingConfig, StreamConfig
    from streaming_vlm_tpu_torch.parallel.distributed import initialize
    from streaming_vlm_tpu_torch.parallel.mesh import make_mesh
    from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

    t0 = time.perf_counter()
    initialize(device="cuda:0", init_method=f"file://{init_file}", world_size=1, rank=0)
    try:
        greedy = SamplingConfig(do_sample=False)
        stream = StreamConfig(kv_quant="int8", window_size=PAR_WINDOW, text_round=PAR_WINDOW,
                              max_tokens_per_chunk=PAR_MAX_NEW)
        model, runs = _par_w8a8(cfg), {}
        torch.cuda.reset_peak_memory_stats()
        for tag, mesh in (("none", None), ("nccl", make_mesh({"model": 1}))):
            eng = StreamingEngine(cfg, model, stream, greedy, mesh=mesh)
            runs[tag] = [g for g, _ in _par_chunks(cfg, eng, 2, np.random.default_rng(0))[0]]
            del eng
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()
    return dict(equal=runs["none"] == runs["nccl"], backend=backend,
                seconds=time.perf_counter() - t0, tokens=runs["nccl"],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _spawn_world(target, argss: list, timeout: float) -> list:
    """Start one process a rank (torch.multiprocessing, spawn: CUDA is live
    here), collect each rank's (ok, result), join them all; a failed or
    silent rank fails the run with its traceback."""
    import queue as queue_mod

    import torch.multiprocessing as tmp_mp

    ctx = tmp_mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*a, q)) for a in argss]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.perf_counter() + timeout
    try:
        while len(results) + len(errors) < len(procs):
            try:
                rank, ok, value = q.get(timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                raise AssertionError(f"slice O: a rank sent nothing within {timeout:.0f} s")
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("slice O: a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in sorted(results)]


def phase_parallel(cfg, noise: dict) -> tuple:
    """Slice O (see PAR_*): one 2-rank gloo world on cuda:0 runs O1-O5, then
    a one-rank NCCL world in this process runs O6. Checks that the ranks agree, the
    comparisons with the one-card paths, and that each part's kernels
    launched. Returns (launches summed over the ranks and parts, stats)."""
    import collections
    import tempfile

    import torch

    pcfg = _par_cfg(cfg)
    L, max_new = PAR_LAYERS, PAR_MAX_NEW
    vision = 5 * PAR_BLOCKS + 2
    k1, k2, k3 = ("streaming_prefill_attention", "streaming_decode_attention_full",
                  "streaming_decode_attention_int8")
    expect_c = {k1: L, k2: L * max_new, "int8_gemm": 7 * L * (1 + max_new) + 1 + max_new + vision,
                "int8_gemm/tiled": 7 * L + vision, "int8_gemm/gemv": 7 * L * max_new + 1 + max_new}
    expect_b = {k1: L, k3: L * max_new}
    stats, launches = {}, collections.Counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        t0 = time.perf_counter()
        ranks = _spawn_world(_slice_o_rank, [(r, f"{tmp}/store", (pcfg, expect_c, expect_b,
                                                                   noise, tmp)) for r in (0, 1)],
                             PAR_TIMEOUT)
        world_s = time.perf_counter() - t0
        o6 = _par_o6(pcfg, f"{tmp}/nccl_store")
    r0, r1 = ranks
    for part in ("O1", "O2", "O3", "O4", "O5"):
        for r in ranks:
            launches.update(r[part].get("counts", {}))
        print(f"  {part}: {r0[part]['seconds']:.1f} s (rank 1 {r1[part]['seconds']:.1f} s), "
              f"{r0[part]['backend']}, peak {r0[part]['peak_gib']:.2f} / "
              f"{r1[part]['peak_gib']:.2f} GiB (rank 0 / 1)")
    fails = []
    # O1: ranks agree after every chunk; chunk 0's logits; evictions in the last two
    o1 = (r0["O1"], r1["O1"])
    if o1[0]["c"] != o1[1]["c"] or o1[0]["b"] != o1[1]["b"]:
        fails.append("O1: the ranks' tokens or host state differ")
    if not any(o1[0]["evicted"][-2:]):
        fails.append("O1: no eviction in the last two chunks")
    err = max(o["logit_rel_err"] for o in o1)
    fault = min(o["fault_logit_rel_err"] for o in o1)
    w8a8_err = max(o["w8a8_logit_rel_err"] for o in o1)
    print(f"  O1: {PAR_CHUNKS} W8A8 chunks (evictions {o1[0]['evicted']}) + 2 raw-arena bf16 "
          f"chunks, ranks agree: {o1[0]['c'] == o1[1]['c'] and o1[0]['b'] == o1[1]['b']}; chunk "
          f"0 logits vs the unsharded engine, max |diff| / max |logit|: bf16 {err:.3e} (limit "
          f"{PAR_LOGIT_TOL:.3e}), with layer 0's kv heads swapped between the ranks {fault:.3e} "
          f"(must exceed the limit), W8A8 {w8a8_err:.3e} (loose bound "
          f"{PAR_W8A8_LOGIT_TOL:.3e}); per-chunk launches equal the single-card path's")
    if err > PAR_LOGIT_TOL:
        fails.append(f"O1: chunk 0's bf16 logits differ by {err:.3e} of the largest")
    if fault <= PAR_LOGIT_TOL:
        fails.append(f"O1: a kv-head swap between the ranks reads {fault:.3e}, within the limit")
    if w8a8_err > PAR_W8A8_LOGIT_TOL:
        fails.append(f"O1: chunk 0's W8A8 logits differ by {w8a8_err:.3e} of the largest")
    for tag in ("data", "model"):  # O2
        a, b = r0["O2"][tag], r1["O2"][tag]
        agree = a["states"] == b["states"]
        e = max(a["logit_rel_err"], b["logit_rel_err"])
        print(f"  O2 {tag}=2: lanes {a['lanes']} / {b['lanes']}, {PAR_ROUNDS} rounds, ranks "
              f"agree: {agree}; round 0 W8A8 logits vs the single-card engine {e:.3e} (loose "
              f"bound {PAR_W8A8_LOGIT_TOL:.3e})")
        if not agree or e > PAR_W8A8_LOGIT_TOL:
            fails.append(f"O2 {tag}: agree={agree} logit err {e:.3e}")
    o3 = r0["O3"]
    full = {k: r0["O3"]["launches"][k] + r1["O3"]["launches"][k]
            for k in ("full_block_attention", "attention_bwd_full")}
    print(f"  O3: sft_loss_sp T={SP_T} over seq=2: loss {o3['loss']:.6f} vs one card "
          f"{o3['ref_loss']:.6f} (rel {o3['loss_rel_err']:.3e}); worst gradient leaf "
          f"{o3['grad_worst_leaf']} rel L2 {o3['grad_rel_l2_max']:.3e}; full-block launches "
          f"(both ranks) {full}")
    if (o3["loss_rel_err"] > TRAIN_LOSS_TOL or not o3["grads_ok"] or not all(full.values())):
        fails.append("O3: sp loss / gradients / full-block launches")
    o4 = (r0["O4"], r1["O4"])
    rep_equal = o4[0]["replicated"] == o4[1]["replicated"]
    print(f"  O4: sft_loss_pp over stage=2, 2 microbatches of {PP_T}: loss {o4[0]['loss']:.6f} vs "
          f"one card {o4[0]['ref_loss']:.6f}; worst leaf rank 0 {o4[0]['grad_worst_leaf']} "
          f"{o4[0]['grad_rel_l2_max']:.3e}, rank 1 {o4[1]['grad_worst_leaf']} "
          f"{o4[1]['grad_rel_l2_max']:.3e}; replicated gradients equal on both ranks: {rep_equal}")
    if not (rep_equal and all(o["grads_ok"] and o["loss_rel_err"] <= TRAIN_LOSS_TOL for o in o4)):
        fails.append("O4: pp loss / gradients / replicated parameters")
    o5 = (r0["O5"], r1["O5"])
    m, ref = o5[0]["metrics"], o5[0]["ref_metrics"]
    close = all(abs(a[k] - b[k]) <= TRAIN_LOSS_TOL * abs(b[k]) for a, b in zip(m, ref)
                for k in ("loss", "grad_norm")) and all(
        a["labeled_tokens"] == b["labeled_tokens"] for a, b in zip(m, ref))
    print(f"  O5: Trainer gspmd data=2, 2 steps: loss {[x['loss'] for x in m]} vs one card "
          f"{[x['loss'] for x in ref]}, grad_norm {[x['grad_norm'] for x in m]} vs "
          f"{[x['grad_norm'] for x in ref]}; AdamW moments {o5[0]['moment_bytes'] / 2**30:.3f} / "
          f"{o5[1]['moment_bytes'] / 2**30:.3f} GiB a rank against "
          f"{o5[0]['ref_moment_bytes'] / 2**30:.3f} GiB on one card")
    if not close or m != o5[1]["metrics"]:
        fails.append("O5: the Trainer's metrics")
    print(f"  O6: one-rank {o6['backend']} world in this process, {o6['seconds']:.1f} s, peak "
          f"{o6['peak_gib']:.2f} GiB: tokens bitwise equal to the engine with no mesh: "
          f"{o6['equal']}")
    if not o6["equal"] or o6["backend"] != "nccl":
        fails.append("O6: the NCCL world's tokens")
    if fails:
        raise AssertionError("slice O: " + "; ".join(fails))
    stats = dict(world_seconds=world_s, o1_logit_rel_err=err, o1_fault_logit_rel_err=fault,
                 o1_w8a8_logit_rel_err=w8a8_err, o3=dict(
        {k: v for k, v in o3.items() if k not in ("counts",)}, full_block_launches=full),
        o5_moment_bytes=[o["moment_bytes"] for o in o5], o5_one_card=o5[0]["ref_moment_bytes"],
        seconds={p: r0[p]["seconds"] for p in ("O1", "O2", "O3", "O4", "O5")},
        peak_gib={p: [r[p]["peak_gib"] for r in ranks] for p in ("O1", "O2", "O3", "O4", "O5")})
    return launches, stats


def _pool(starts, n: int, timeout: float = 900.0) -> list:
    """Run the processes that `starts` (callables returning a Popen) start,
    n at a time, each next one as soon as any running one has ended; waits
    for all (each within `timeout` s of its start). Returns the Popens, in
    order."""
    procs, running, begun = [], [], {}
    for start in starts:
        while len(running) == n:
            for p in running:
                if p.poll() is not None:
                    running.remove(p)
                    break
                if time.perf_counter() - begun[p] > timeout:
                    p.kill()
                    raise RuntimeError(f"{p.args} ran past {timeout} s")
            else:
                time.sleep(0.1)
        p = start()
        begun[p] = time.perf_counter()
        procs.append(p)
        running.append(p)
    for p in running:
        p.wait(timeout=max(1.0, timeout - (time.perf_counter() - begun[p])))
    return procs


def phase_mutants() -> dict:
    """For each fault in MUTANTS: copy the port, this script and the
    checkout's compiled kernel objects into build/mutants/<i>/ (git-
    ignored), apply the fault there, build the copies' kernels
    (MUTANT_BUILDS at a time; each compiles only the sources its fault
    changed), then run phase 3's checks
    (not its timings) in each copy in a subprocess. Each must fail, on the
    named kernels' checks only (and, where MUTANTS gives a text, only on
    checks that contain it). Returns {fault: {"kernel", "failed": checks
    failed, "of": the kernel's checks, "failed_checks",
    "max_err_over_limit" (tolerance checks) or None (bitwise checks)}}."""
    import re
    import shutil

    root = REPO / "build" / "mutants"
    shutil.rmtree(root, ignore_errors=True)
    dirs = []
    for i, (name, (kernel, src, text, repl, where)) in enumerate(MUTANTS.items()):
        d = root / str(i)
        shutil.copytree(REPO / "streaming_vlm_tpu_torch", d / "streaming_vlm_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(REPO / "chip_smoke.py", d)
        # the checkout's compiled objects: the copy compiles only what its fault changed
        shutil.copytree(REPO / "build" / "torch_kernels" / "obj",
                        d / "build" / "torch_kernels" / "obj")
        f = d / "streaming_vlm_tpu_torch" / src
        code = f.read_text()
        for a, b in zip(*((text, repl) if isinstance(text, tuple) else ((text,), (repl,)))):
            if code.count(a) != 1:
                raise AssertionError(f"mutant {name!r}: {a!r} is not once in {src}")
            code = code.replace(a, b)
        f.write_text(code)
        dirs.append(d)
    build = [sys.executable, "-c", "from streaming_vlm_tpu_torch.ops import _kernels; _kernels.build()"]
    t0 = time.perf_counter()
    _pool([lambda d=d: subprocess.Popen(build, cwd=d, stdout=subprocess.DEVNULL,
                                        stderr=subprocess.DEVNULL) for d in dirs], MUTANT_BUILDS)
    print(f"  the copies' kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the copies' checks, MUTANT_RUNS processes at a time on the card (each
    # writes to a file: pipes could fill while another process is awaited)
    check = [sys.executable, "-c",
             "import chip_smoke; chip_smoke._TIMED = False; chip_smoke.phase_kernels()"]

    def start_check(d):
        with open(d / "out.txt", "w") as out, open(d / "err.txt", "w") as err:
            return subprocess.Popen(check, cwd=d, stdout=out, stderr=err, text=True)

    runs = dict(zip(dirs, _pool([lambda d=d: start_check(d) for d in dirs], MUTANT_RUNS)))
    print(f"  the copies' checks ran in {time.perf_counter() - t0:.1f} s")
    found = {}
    for d, (name, (kernel, src, text, repl, where)) in zip(dirs, MUTANTS.items()):
        r = subprocess.CompletedProcess(check, runs[d].returncode, (d / "out.txt").read_text(),
                                        (d / "err.txt").read_text())
        kernels = {kernel} if isinstance(kernel, str) else set(kernel)
        lines = r.stdout.splitlines()
        checks = [x.strip() for x in lines
                  if re.match(r"  (K\d(-int4|-verify|-bwd)?|CE-row)(\+K\d)*( merged)? \{", x)]
        mine = [x for x in checks if set(x.split(" ", 1)[0].split("+")) & kernels]
        failed = [x for x in checks if x.endswith("FAIL")]
        print(f"  mutant {name!r}: exit {r.returncode}, {len(failed)} checks failed")
        for line in failed:
            print("    " + line)
        wheres = (where,) if isinstance(where, str) else where
        ok = r.returncode != 0 and failed and all(
            x in mine and (where is None or any(w in x for w in wheres)) for x in failed)
        if not ok:
            print(r.stdout[-4000:] + r.stderr[-4000:])
            raise AssertionError(f"mutant {name!r} was not rejected by {'/'.join(sorted(kernels))}'s"
                                 " checks alone" + (f" at {' or '.join(wheres)}" if where else ""))
        ratios = [float(m.group(1)) for x in failed if (m := re.search(r"err/limit=([0-9.]+)", x))]
        found[name] = {"kernel": "/".join(sorted(kernels)), "failed": len(failed),
                       "of": len(mine),
                       "failed_checks": [x[: x.index("}") + 1] for x in failed],
                       "max_err_over_limit": max(ratios) if ratios else None}
    shutil.rmtree(root, ignore_errors=True)
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="trace the slices with torch.profiler; kernel tables -> "
                         "DIR/profile_slice_{a,...,i}.txt")
    ap.add_argument("--slices", default="ABCDEFGHIJKLMNO",
                    help="the slices of phase 5 to run (default all: ABCDEFGHIJKLMNO)")
    args = ap.parse_args()
    if not (REPO / "streaming_vlm_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import torch

    t_start = time.perf_counter()
    print("[1/5] device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's smoke test runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"[2/5] build (at {time.perf_counter() - t_start:.1f} s)")
    from streaming_vlm_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    ptxas = {src: _ptxas_verbose(_kernels, src)
             for src in ("prefill_attention.cu", "decode_attention.cu", "decode_attention_raw.cu",
                         "int8_gemm.cu", "int4_gemv.cu", "verify_attention.cu", "attention_bwd.cu",
                         "linear_ce.cu")}
    so = _kernels.build()
    _kernels.lib()
    print(f"  {so.name}: {time.perf_counter() - t0:.2f} s (nvcc {_kernels.build_seconds} s)")
    text = {src: _ptxas_text(p) for src, p in ptxas.items()}
    for what, src, kernel in (
            ("K1", "prefill_attention.cu", "prefill_attention_kernelILb0E"),
            ("K1 with its log-sum-exp", "prefill_attention.cu", "prefill_attention_kernelILb1E"),
            ("K2 (bf16 out, small block)", "decode_attention.cu", "decode_split_kernelILb1E"),
            ("K4", "decode_attention.cu", "decode_split_kernelILb0E"),
            ("K2-verify", "verify_attention.cu", "verify_tc_kernel"),
            ("K3 int8 arena", "decode_attention_raw.cu", "decode_raw_kernelILb1E"),
            ("K3 bf16 arena", "decode_attention_raw.cu", "decode_raw_kernelILb0E"),
            ("K5 tiled, tile 128x256, bf16 out", "int8_gemm.cu", "gemm_tiled_kernelILi256E13__nv_bfloat16"),
            ("K5 tiled, tile 128x128, bf16 out", "int8_gemm.cu", "gemm_tiled_kernelILi128E13__nv_bfloat16"),
            ("K5 decode GEMV, bf16 in and out", "int8_gemm.cu", "gemv_kernelI13__nv_bfloat16S"),
            ("K5-int4, one row tile (4 dtype forms)", "int4_gemv.cu", "Li1EE"),
            ("K1-bwd (the five products)", "attention_bwd.cu", "attn_bwd_kernel"),
            ("K1-bwd full-block (clusters of two)", "attention_bwd.cu", "attn_bwd_full_kernel"),
            ("K1-bwd pre pass (D, records)", "attention_bwd.cu", "attn_bwd_prep_kernel"),
            ("K1-bwd post pass (dQ to bf16)", "attention_bwd.cu", "attn_bwd_dq_kernel"),
            ("CE-row", "linear_ce.cu", "ce_rows_kernel")):
        print(f"  {what} " + _ptxas_lines(text[src], kernel))
    # K1's consumers hold O, S and P (160 registers) through the key loop
    # at setmaxnreg's 240: a spill there is a load and a store a tile
    for kernel in ("prefill_attention_kernelILb0E", "prefill_attention_kernelILb1E"):
        line = _ptxas_lines(text["prefill_attention.cu"], kernel)
        if " 0 bytes spill stores, 0 bytes spill loads" not in line:
            raise AssertionError(f"K1 ({kernel}) spills: {line}")
    from streaming_vlm_tpu_torch.ops.attention import attention_bwd_clusters

    width, resident = attention_bwd_clusters()
    print(f"  K1-bwd full-block launches clusters of {width} CTAs, {resident} resident at once")
    if width != 2:
        raise AssertionError(f"K1-bwd full-block: clusters of {width}, not 2")

    print(f"[3/5] kernels vs plain versions (at {time.perf_counter() - t_start:.1f} s)")
    kstats = phase_kernels()
    print(f"  (at {time.perf_counter() - t_start:.1f} s)")
    print("  phase 3 against copies of the port with K1, K2, K3, K5, K5-int4, K2-verify, K1-bwd "
          "or CE-row broken on purpose")
    soak = None
    if "N" in args.slices:  # slice N's CLI process: beside the mutants and phase 4
        soak = start_soak()
        atexit.register(lambda: soak.poll() is None and soak.kill())
        print("  slice N's soak started (python -m streaming_vlm_tpu_torch soak)")
    print("  " + json.dumps({"mutants": phase_mutants()}))

    from streaming_vlm_tpu_torch.config import StreamConfig, qwen2_vl_7b, qwen25_vl_7b
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import (
        init_params,
        random_quantized_model,
    )

    from streaming_vlm_tpu_torch.ops import quant as Q

    cfg, cfg2 = qwen25_vl_7b(), qwen2_vl_7b()
    print(f"[4/5] reference: streaming forward vs plain oracle at 7B width "
          f"(at {time.perf_counter() - t_start:.1f} s)")
    phase_reference(cfg)
    print(f"  {cfg2.name} (its decoder's widths: the bf16 and W8A8 cases)")
    phase_reference(cfg2, cases="ac")
    phase_vision_reference(cfg2)
    print(f"  {cfg.name}: the batched MCQ forward (K1 lanes at visible 0) against forward_full")
    phase_mcq_reference(cfg)
    print(f"  {cfg.name}: the spec-decode verify forward")
    r_verify = phase_verify_reference(cfg)
    print(f"  {cfg.name}: training, sft_loss and its text gradients (K1, K1-bwd, CE-row)")
    train_ref = phase_train_reference(cfg)
    train_noise = train_ref.pop("noise")  # each leaf's bf16 noise, for slice O's limits

    print(f"[5/5] slices: the serving entry points at 7B width (at {time.perf_counter() - t_start:.1f} s)")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.text.num_hidden_layers} layers, random bf16 weights "
          f"in {time.perf_counter() - t0:.2f} s")
    L, max_new = cfg.text.num_hidden_layers, StreamConfig().max_tokens_per_chunk
    k1, k2 = "streaming_prefill_attention", "streaming_decode_attention_full"
    k3 = "streaming_decode_attention_int8"

    def k5(blocks: int, per_block: int) -> dict:
        """K5's launches a chunk with W8A8 weights: the 7 projections of
        every layer in the prefill and in each decode step, the lm_head
        after each, and `per_block` products per vision block plus the
        merger's 2 (one vision encode a chunk); the tiled path runs the
        prefill's and the vision tower's, the GEMV the decode steps' and
        every lm_head (one row each)."""
        vision = per_block * blocks + 2
        return {"int8_gemm": 7 * L * (1 + max_new) + (1 + max_new) + vision,
                "int8_gemm/tiled": 7 * L + vision,
                "int8_gemm/gemv": 7 * L * max_new + 1 + max_new}

    # W4A8 (slice I): K5-int4 runs every decode product (7 a layer) and
    # every one-row lm_head (the prefill's last row and each decode step's);
    # the prefill's products take qdot4's bf16 path; the vision tower stays
    # int8 (K5 tiled: 5 products a block + the merger's 2)
    vision25 = 5 * cfg.vision.depth + 2
    w4a8 = {k1: L, k2: L * max_new, "int8_gemm": vision25, "int8_gemm/tiled": vision25,
            "int8_gemm/int4": 7 * L * max_new + max_new + 1}
    # efficiency config (c) (eval/efficiency.py): window 16, text rounds 16,
    # no previous-text sink or window, the cache recomputed every chunk;
    # kv_capacity_for(16, ., 560) = 14848 slots, buckets past 4096 so that
    # the re-prefilled window (~8.9k tokens from chunk 16 on) fits
    recompute = StreamConfig(window_size=16, text_round=16, text_sink=None,
                             text_sliding_window=None, kv_capacity=14848,
                             prefill_buckets=StreamConfig().prefill_buckets + (8192, 10240))
    slices = {  # name -> (weights, StreamConfig, launches per chunk, recompute)
        "A": ("bf16", StreamConfig(), {k1: L, k2: L * max_new}, False),
        "B": ("bf16", StreamConfig(kv_quant="int8", prerotate_arena=False),
              {k1: L, k3: L * max_new}, False),
        "H": ("bf16", recompute, {k1: L, k2: L * max_new}, True),
        "I": ("W4A8", StreamConfig(kv_quant="int8"), w4a8, False),
        # K5: 5 products a Qwen2.5-VL vision block (qkv, proj, gate, up, down)
        "C": ("W8A8", StreamConfig(kv_quant="int8"),
              {k1: L, k2: L * max_new, **k5(cfg.vision.depth, 5)}, False),
    }
    by_slice, slice_stats, loaded = {}, {}, "bf16"
    # N: the evaluation harnesses, the LiveCC baseline, the demo and the CLI
    # on these bf16 weights (the soak subprocess: random 3B W8A8)
    if "N" in args.slices:
        print(f"  slice N: eval harnesses, LiveCC, demo and CLI, bf16 weights, raw clips "
              f"(at {time.perf_counter() - t_start:.1f} s)")
        by_slice["N"], slice_stats["N"] = phase_eval(cfg, model, soak)

    def w8a8(c):  # the caller has dropped the model before
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        m = random_quantized_model(c, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda")
        torch.cuda.synchronize()
        print(f"  {c.name}: random W8A8 weights in {time.perf_counter() - t0:.2f} s")
        return m

    for name, (weights, stream, expect, rec) in slices.items():
        if name not in args.slices:
            continue
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        if weights != loaded and weights == "W4A8":  # the bf16 weights, quantized in place
            if loaded != "bf16":
                del model
                torch.cuda.empty_cache()
                model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                    device="cuda", dtype=torch.bfloat16)
            t0 = time.perf_counter()
            model, loaded = Q.quantize_model(model, bits=4), weights
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            print(f"  {cfg.name}: slice A's bf16 weights -> W4A8 (quantize_model(bits=4)) in "
                  f"{time.perf_counter() - t0:.2f} s")
        elif weights != loaded:  # W8A8: free the bf16 (or W4A8) model first
            del model
            model, loaded = w8a8(cfg), weights
        print(f"  slice {name}: {weights} weights, kv_quant={stream.kv_quant} "
              f"prerotate={stream.effective_prerotate}" + (
                  f", recompute, kv_capacity={stream.kv_capacity}, buckets "
                  f"{stream.prefill_buckets}" if rec else ""))
        prof = args.profile / f"profile_slice_{name.lower()}.txt" if args.profile else None
        by_slice[name], slice_stats[name] = phase_slice(cfg, model, N_CHUNKS, stream, expect,
                                                        prof, recompute=rec)
    # L: speculative decoding on C's W8A8 weights, C's arena, a window of 4
    # chunks (eviction within 8), greedy; r from phase 4's W8A8 case
    if "L" in args.slices:
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        if loaded != "W8A8":
            del model
            model, loaded = w8a8(cfg), "W8A8"
        print(f"  slice L: speculative decoding, W8A8 weights, kv_quant=int8, greedy, window 4, "
              f"k_draft {SPEC_K}, {SPEC_CHUNKS} chunks four ways (autoregressive, no draft, "
              f"adversarial, clairvoyant)")
        by_slice["L"], slice_stats["L"] = phase_spec(
            cfg, model, StreamConfig(kv_quant="int8", window_size=4, text_round=4),
            r_verify["W8A8, int8 pre-rotated (K5, K1, K2-verify)"], vision25)
    if "I" in slice_stats and "C" in slice_stats:
        i_, c_ = slice_stats["I"], slice_stats["C"]
        print(f"  W4A8 (I) against W8A8 (C), this run: chunk p50 {i_['chunk_p50_ms']:.2f} vs "
              f"{c_['chunk_p50_ms']:.2f} ms, max {i_['chunk_max_ms']:.2f} vs "
              f"{c_['chunk_max_ms']:.2f} ms")

    # D, E, F: B lanes in lockstep rounds through MultiStreamEngine on the W8A8
    # weights. Per round: K1 once a layer; K2 (or K3) once a layer a decode
    # step; K5 for the 7 projections of every layer in the prefill and in
    # each decode step and for each lm_head (tiled above SMALL_M rows, else
    # the GEMV), and 5 a vision block + 2 for each lane's tower call
    ms_slices = {  # name -> (lanes, StreamConfig)
        "D": (6, StreamConfig(kv_quant="int8")),
        "E": (8, StreamConfig(kv_quant="int8", rot_quant="int8")),
        "F": (4, StreamConfig(kv_quant="int8", prerotate_arena=False)),
    }
    ms_stats = {}
    # D-F, J and K run the decoder cut to MS_LAYERS layers (the run's time
    # limit; the tower whole)
    cfg_ms = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                               num_hidden_layers=MS_LAYERS))
    Lm = MS_LAYERS
    if set(args.slices) & set("DEFJK"):
        del model
        model, loaded = w8a8(cfg_ms), "W8A8 cut"
    for name, (B, stream) in ms_slices.items():
        if name not in args.slices:
            continue
        dec = k2 if stream.effective_prerotate else k3
        vision = B * vision25
        decode = 7 * Lm * max_new + 1 + max_new
        small = B <= Q.lib().int8_small_m
        expect = {k1: Lm, dec: Lm * max_new, "int8_gemm": 7 * Lm + vision + decode,
                  "int8_gemm/tiled": 7 * Lm + vision + (0 if small else decode),
                  "int8_gemm/gemv": decode if small else 0}
        print(f"  slice {name}: {B} lanes, W8A8 weights ({Lm} layers), kv_quant={stream.kv_quant} "
              f"prerotate={stream.effective_prerotate} rot_quant={stream.rot_quant}")
        prof = args.profile / f"profile_slice_{name.lower()}.txt" if args.profile else None
        by_slice[name], ms_stats[name] = phase_multistream(cfg_ms, model, stream, B, expect, prof)
    print("  " + json.dumps({"multistream": ms_stats}))

    # J: snapshots (W8A8, C's stream; K1/K2, the raw arena's K1/K3, K5 both
    # paths); K: the oversubscribed server (4 lanes: K5's decode GEMV)
    if "J" in args.slices:
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        print(f"  slice J: snapshot / resume, W8A8 weights, kv_quant=int8, sampled; pre-rotated "
              f"and raw arenas, then {SNAP_LANES} lanes")
        by_slice["J"], slice_stats["J"] = phase_snapshots(
            cfg_ms, model, StreamConfig(kv_quant="int8"),
            (k1, k2, k3, "int8_gemm/gemv", "int8_gemm/tiled"))
    if "K" in args.slices:
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        print(f"  slice K: MultiStreamServer, {SERVER_CLIENTS} clients on {SERVER_LANES} lanes "
              f"(max_clients={SERVER_CLIENTS}), W8A8 weights, kv_quant=int8")
        by_slice["K"], slice_stats["K"] = phase_server(
            cfg_ms, model, StreamConfig(kv_quant="int8"),
            (k1, k2, "int8_gemm/gemv", "int8_gemm/tiled"))

    # G: Qwen2-VL-7B (all 28 layers, 32 vision blocks), random W8A8 weights,
    # bench.py's 7B serving defaults, through bench.py's single-stream
    # route. K5: 4 products a Qwen2-VL vision block (qkv, proj, fc1, fc2)
    if "G" in args.slices:
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        del model
        model, loaded = w8a8(cfg2), "W8A8 qwen2"
        print(f"  slice G: {cfg2.name}, W8A8 weights, kv_quant=int8, bench.py's route "
              f"(prewarm, warm chunk, frames uploaded and patchified on the card, a qa question "
              f"at chunk {QA_AT})")
        prof = args.profile / "profile_slice_g.txt" if args.profile else None
        by_slice["G"], slice_stats["G"] = phase_bench_route(
            cfg2, model, N_CHUNKS, StreamConfig(kv_quant="int8"),
            {k1: L, k2: L * max_new, **k5(cfg2.vision.depth, 4)}, prof)
    del model
    torch.cuda.empty_cache()
    # M: training (Trainer, StreamDataset, K1 + K1-bwd + CE-row), then the
    # resume / prefetch check at narrow widths
    def memory(before: str) -> None:  # what the earlier slices left on the card
        print(f"  before slice {before}: memory_allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, memory_reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")

    if "M" in args.slices:
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        memory("M")
        # then what only the cycle collector frees: tensors held by reference
        # cycles (none expected: such a cycle would leak a model from a
        # long-lived server until the collector happens to run)
        n_cyclic = gc.collect()
        torch.cuda.empty_cache()
        print(f"  ({n_cyclic} objects in reference cycles collected)")
        memory("M, after gc.collect()")
        print(f"  slice M: training, {cfg.name} widths with {TRAIN_LAYERS} decoder layers, "
              f"random bf16 weights, a {TRAIN_CLIP} s 476x840 clip, grad_accum 2, max_steps 2, "
              f"remat full, prefetch 2")
        with _raw_clips():
            by_slice["M"], slice_stats["M"] = phase_train(cfg)
            slice_stats["M"]["resume"] = phase_train_resume()
        slice_stats["M"]["reference"] = train_ref
    # O: the parallel modes, two ranks on this card over gloo, then a
    # one-rank NCCL world
    if "O" in args.slices:
        torch.cuda.empty_cache()
        print(f"  (at {time.perf_counter() - t_start:.1f} s)")
        memory("O")
        print(f"  slice O: parallel/ at {cfg.name} widths, {PAR_LAYERS} decoder layers, "
              f"{PAR_BLOCKS} vision blocks: 2 ranks on cuda:0 over gloo (O1-O5), then 1 rank "
              f"over NCCL (O6); no speed is claimed")
        t0 = time.perf_counter()
        by_slice["O"], slice_stats["O"] = phase_parallel(cfg, train_noise)
        print(f"  slice O: {time.perf_counter() - t0:.1f} s")
    print("  " + json.dumps({"slices": slice_stats}))

    def launches(key):
        return dict(launches=sum(c[key] for c in by_slice.values()),
                    launches_by_slice={s: c[key] for s, c in by_slice.items()})

    kernels = [{"name": n, "route": "cuda", "source": SRC[n][0], "replaces": SRC[n][1],
                **launches(n), **kstats[n]}
               for n in SRC if not n.startswith("int8_gemm")]
    for path in ("gemv", "tiled", "int4"):  # K5's paths and K5-int4, each its own launches
        key = f"int8_gemm/{path}"
        src = SRC[key] if key in SRC else SRC["int8_gemm"]
        kernels.append({"name": key, "route": "cuda", "source": src[0], "replaces": src[1],
                        **launches(key), **kstats["int8_gemm"][path]})
    print(f"  all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
