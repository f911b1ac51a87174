#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # the full run (one card)

Phases; any failure exits non-zero:

1. device: requires CUDA; prints `nvidia-smi` name and power limit.
2. build: compiles the port's kernels (streaming_vlm_tpu_torch/csrc, nvcc,
   sm_90a, one nvcc per source in parallel) into build/torch_kernels/, and
   prints -Xptxas -v registers and spills of K1-K5's kernels.
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
   partials (and their merge with the small block against K2), K5 W8A8
   products (the int32 form at the TPU probe's 4096^3 and at ragged shapes;
   the serving form at every (M, K, N) of the 7B path, Qwen2-VL's vision
   products included, bf16 and f32 out, weights in QLinear's padded rows). K1 and the decode kernels are held to
   one bf16 ulp of each output value (plus one ulp of the largest for K1, a
   small fraction of it for the others), K5 to bitwise equality, and phase
   3 is run again on copies of the port with K1 (kernel or plan), K2, K3 or
   K5 (kernel or plan) broken on purpose (MUTANTS): each copy must fail, on
   the broken kernel's checks only. K1's plan must reach the card without a
   host sync. The lane forms (B streams in one launch, per-lane lengths:
   K2 and K3 at B in {1, 4, 8} with lanes shorter than one split and empty
   ones, both storage forms of K3, K1 at 6 ragged lanes in both modes) are
   held to the same tolerances against their plain lane versions, and
   their own mutants must fail their lane checks alone. Times from CUDA events and profiler device time, beside each
   kernel's bound and, where one PyTorch call computes the same function,
   that call's time (K5's int32 form at every tiled shape beside
   torch._int_mm; K2's and K3's device time at visible 640, 4500 and
   9000). K3's bound counts the f32 work that its dtype chain keeps off the
   tensor cores at the f32 rate beside its bytes.
4. reference: at 7B width (decoder cut to 4 layers), the streaming forward
   through the kernels (chunk prefill, then one decode token) in bf16
   against the plain full-attention oracle `language_forward` in f32 on the
   same random weights: over the pre-rotated bf16 arena (K1, K2), over the
   int8 raw arena (K1 raw mode, K3), and with W8A8 weights over the int8
   pre-rotated arena (K5, K1, K2; the oracle runs the dequantized weights);
   the same at Qwen2-VL-7B's widths (bf16 and W8A8), and Qwen2-VL-7B's
   vision tower (4 of its blocks, one chunk's frames patchified on the card)
   in bf16 and W8A8 (K5) against its f32 oracle.
5. slices: Qwen2.5-VL-7B served through `serve.streaming_inference_frames`,
   20 one-second chunks of 2 synthetic 476x840 frames each, three times:
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
   MultiStreamEngine on the W8A8 weights (warm round + reset_lane, 20
   rounds, the last lane idle in rounds 3 and 11, each lane its own frames
   and query): slice D, 6 lanes over the int8 pre-rotated arena (K1 and K2
   lane forms, K5 tiled at M = 6); slice E, 8 lanes with rot_quant="int8";
   slice F, 4 lanes over the int8 raw arena (K1 raw and K3 lane forms).
   Each prints round wall p50 / max, aggregate ingest frames/s and the
   lanes' occupancy after eviction, and checks its launch counts. Slice G
   serves Qwen2-VL-7B (random W8A8 weights, all 28 layers and 32 vision
   blocks, kv_quant="int8") through bench.py's single-stream route:
   `prewarm`, a throwaway warm chunk, a fresh `StreamingSession`, 20 chunks
   whose frames are uploaded and patchified on the card, the next chunk's
   encode launched behind each step, and bench.py's qa question at chunk
   10 (a larger bucket); it prints p50, max and the qa chunk. Slice H
   serves slice A's bf16 weights in recompute mode (efficiency config (c):
   window 16, text rounds 16, no sink, kv_capacity 14848, buckets to
   10240): every chunk re-encodes its window and re-prefills at cached 0
   (K1 at visible 0, up to ~8.9k tokens), with the bucket of each chunk.

The second-to-last line is a JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
N_CHUNKS = 20  # slice length: past visual_round=16, so eviction runs
REF_NOISE_FACTOR = 2.0
MUTANT_BUILDS = 4  # mutant copies whose kernels build at once (4 nvcc each)
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
# deliberate faults that phase 3 must reject: name -> (the kernel, or
# kernels, whose checks alone must fail, file under streaming_vlm_tpu_torch/,
# text, replacement, a text every failed check must contain or None). A
# check belongs to the kernels its label names before the first space
# ("K2+K4 merged": K4's partials merged with the small block against K2).
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
        "if (tid == 0) counters[head] = 0;",
        "if (tid == 0) counters[kvh] = 0;", "'lanes'",
    ),
}
# the lane forms' checks (phase 3): K2 and K3 at B in {1, 4, 8} lanes with
# these per-lane visible lengths (empty lanes, lanes shorter than one split,
# the whole arena), K1 at slice D's 6 lanes with these insert points
LANE_VISIBLE = {1: ((9000,), (0,)), 4: ((1, 4501, 0, 100), (10240, 641, 9000, 1)),
                8: ((0, 1, 100, 641, 4501, 9000, 10240, 9000),)}
K1_LANE_INSERT_AT = (0, 1, 641, 4501, 9000, 9600)
# multi-stream slices: lanes, rounds, rounds in which the last lane idles
MS_ROUNDS = 20
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
    "int8_gemm": (
        "streaming_vlm_tpu_torch/csrc/int8_gemm.cu",
        "tools/profile_s8_mxu.py:78",
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
    for name, lane_stats in _phase_lanes(g).items():
        stats[name]["lanes"] = lane_stats
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], lane_stats["max_abs_err"])
    stats["int8_gemm"] = _phase_k5(g)
    if _FAILED:
        raise AssertionError("kernels disagree with their plain versions: " + "; ".join(_FAILED))
    return stats


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
              f"{r['device_ms']:.4f} ms), plain "
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
                     bf16_linear_ms=gemv["bf16_linear_ms"], **{k: gemv[k] for k in keys},
                     lm_head=by_shape["lm_head"]),
        "tiled": dict(max_abs_err=err, shape="prefill gate/up_proj (M=640, K=3584, N=18944), "
                      "serving form (row quantization + product + epilogue)",
                      **{k: tiled[k] for k in keys}, int32_form=int32, probe=probe,
                      lanes=lanes, qwen2_vision=qwen2_vision),
    }


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


def phase_reference(cfg, cases: str = "abc"):
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
    plain version). `cases` picks among (a), (b) and (c)."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.ops.quant import (
        LAYER_LINEARS,
        QuantKV,
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

    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops import quant as Q
    from streaming_vlm_tpu_torch.serve import streaming_inference_frames
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
    from streaming_vlm_tpu_torch.utils.buckets import bucket_for

    rng = np.random.default_rng(0)
    # 16:9 under max_pixels_for_window(16) -> grid (1, 34, 60), 510 tokens
    frames = [rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8) for _ in range(n_chunks)]
    prof = _profiler() if profile else contextlib.nullcontext()
    torch.cuda.synchronize()
    A.reset_launch_counts()
    Q.reset_launch_counts()
    t0 = time.perf_counter()
    with prof:
        responses, times = streaming_inference_frames(
            cfg=cfg, model=model, tokenizer=FakeTokenizer(cfg.tokens), frames=frames,
            stream=stream, time_test=True, quiet=True, recompute=recompute,
        )
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**A.launch_counts, **Q.launch_counts,
                **{f"int8_gemm/{k}": v for k, v in Q.path_counts.items()}}
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
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops import quant as Q
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
    A.reset_launch_counts()
    Q.reset_launch_counts()
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
    launches = {**A.launch_counts, **Q.launch_counts,
                **{f"int8_gemm/{k}": v for k, v in Q.path_counts.items()}}
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
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops import quant as Q
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
    A.reset_launch_counts()
    Q.reset_launch_counts()
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
    launches = {**A.launch_counts, **Q.launch_counts,
                **{f"int8_gemm/{k}": c for k, c in Q.path_counts.items()}}
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


def phase_mutants() -> dict:
    """For each fault in MUTANTS: copy the port and this script into
    build/mutants/<i>/ (git-ignored), apply the fault there, build the
    copies' kernels (MUTANT_BUILDS at a time), then run phase 3's checks
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
        f = d / "streaming_vlm_tpu_torch" / src
        code = f.read_text()
        if code.count(text) != 1:
            raise AssertionError(f"mutant {name!r}: {text!r} is not once in {src}")
        f.write_text(code.replace(text, repl))
        dirs.append(d)
    build = [sys.executable, "-c", "from streaming_vlm_tpu_torch.ops import _kernels; _kernels.build()"]
    running = []
    for d in dirs:
        if len(running) == MUTANT_BUILDS:
            running.pop(0).wait()
        running.append(subprocess.Popen(build, cwd=d, stdout=subprocess.DEVNULL,
                                        stderr=subprocess.DEVNULL))
    for p in running:
        p.wait()
    found = {}
    for d, (name, (kernel, src, text, repl, where)) in zip(dirs, MUTANTS.items()):
        r = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke._TIMED = False; chip_smoke.phase_kernels()"],
            cwd=d, capture_output=True, text=True, timeout=600,
        )
        kernels = {kernel} if isinstance(kernel, str) else set(kernel)
        lines = r.stdout.splitlines()
        checks = [x.strip() for x in lines if re.match(r"  K\d(\+K\d)*( merged)? \{", x)]
        mine = [x for x in checks if set(x.split(" ", 1)[0].split("+")) & kernels]
        failed = [x for x in checks if x.endswith("FAIL")]
        print(f"  mutant {name!r}: exit {r.returncode}, {len(failed)} checks failed")
        for line in failed:
            print("    " + line)
        ok = r.returncode != 0 and failed and all(
            x in mine and (where is None or where in x) for x in failed)
        if not ok:
            print(r.stdout[-4000:] + r.stderr[-4000:])
            raise AssertionError(f"mutant {name!r} was not rejected by {'/'.join(sorted(kernels))}'s"
                                 " checks alone" + (f" at {where}" if where else ""))
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
                         "DIR/profile_slice_{a,...,h}.txt")
    ap.add_argument("--slices", default="ABCDEFGH",
                    help="the slices of phase 5 to run (default all: ABCDEFGH)")
    args = ap.parse_args()
    if not (REPO / "streaming_vlm_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import torch

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

    print("[2/5] build")
    from streaming_vlm_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    ptxas = {src: _ptxas_verbose(_kernels, src)
             for src in ("prefill_attention.cu", "decode_attention.cu", "decode_attention_raw.cu",
                         "int8_gemm.cu")}
    so = _kernels.build()
    _kernels.lib()
    print(f"  {so.name}: {time.perf_counter() - t0:.2f} s (nvcc {_kernels.build_seconds} s)")
    text = {src: _ptxas_text(p) for src, p in ptxas.items()}
    for what, src, kernel in (
            ("K1", "prefill_attention.cu", "prefill_attention_kernel"),
            ("K2 (bf16 out, small block)", "decode_attention.cu", "decode_split_kernelILb1E"),
            ("K4", "decode_attention.cu", "decode_split_kernelILb0E"),
            ("K3 int8 arena", "decode_attention_raw.cu", "decode_raw_kernelILb1E"),
            ("K3 bf16 arena", "decode_attention_raw.cu", "decode_raw_kernelILb0E"),
            ("K5 tiled, tile 128x256, bf16 out", "int8_gemm.cu", "gemm_tiled_kernelILi256E13__nv_bfloat16"),
            ("K5 tiled, tile 128x128, bf16 out", "int8_gemm.cu", "gemm_tiled_kernelILi128E13__nv_bfloat16"),
            ("K5 decode GEMV, bf16 in and out", "int8_gemm.cu", "gemv_kernelI13__nv_bfloat16S")):
        print(f"  {what} " + _ptxas_lines(text[src], kernel))

    print("[3/5] kernels vs plain versions")
    kstats = phase_kernels()
    print("  phase 3 against copies of the port with K1, K2, K3 or K5 broken on purpose")
    print("  " + json.dumps({"mutants": phase_mutants()}))

    from streaming_vlm_tpu_torch.config import StreamConfig, qwen2_vl_7b, qwen25_vl_7b
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import (
        init_params,
        random_quantized_model,
    )

    from streaming_vlm_tpu_torch.ops import quant as Q

    cfg, cfg2 = qwen25_vl_7b(), qwen2_vl_7b()
    print("[4/5] reference: streaming forward vs plain oracle at 7B width")
    phase_reference(cfg)
    print(f"  {cfg2.name} (its decoder's widths: the bf16 and W8A8 cases)")
    phase_reference(cfg2, cases="ac")
    phase_vision_reference(cfg2)

    print("[5/5] slices: the serving entry points at 7B width")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.text.num_hidden_layers} layers, random bf16 weights "
          f"in {time.perf_counter() - t0:.2f} s")
    L, max_new = cfg.text.num_hidden_layers, StreamConfig().max_tokens_per_chunk
    k1, k2 = "streaming_prefill_attention", "streaming_decode_attention_full"

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
              {k1: L, "streaming_decode_attention_int8": L * max_new}, False),
        "H": ("bf16", recompute, {k1: L, k2: L * max_new}, True),
        # K5: 5 products a Qwen2.5-VL vision block (qkv, proj, gate, up, down)
        "C": ("W8A8", StreamConfig(kv_quant="int8"),
              {k1: L, k2: L * max_new, **k5(cfg.vision.depth, 5)}, False),
    }
    by_slice, slice_stats, loaded = {}, {}, "bf16"

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
        if weights != loaded:  # W8A8: free the bf16 model first
            del model
            model, loaded = w8a8(cfg), weights
        print(f"  slice {name}: {weights} weights, kv_quant={stream.kv_quant} "
              f"prerotate={stream.effective_prerotate}" + (
                  f", recompute, kv_capacity={stream.kv_capacity}, buckets "
                  f"{stream.prefill_buckets}" if rec else ""))
        prof = args.profile / f"profile_slice_{name.lower()}.txt" if args.profile else None
        by_slice[name], slice_stats[name] = phase_slice(cfg, model, N_CHUNKS, stream, expect,
                                                        prof, recompute=rec)

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
    if set(args.slices) & set(ms_slices) and loaded != "W8A8":
        del model
        model, loaded = w8a8(cfg), "W8A8"
    for name, (B, stream) in ms_slices.items():
        if name not in args.slices:
            continue
        dec = "streaming_decode_attention_full" if stream.effective_prerotate else \
            "streaming_decode_attention_int8"
        vision = B * (5 * cfg.vision.depth + 2)
        decode = 7 * L * max_new + 1 + max_new
        small = B <= Q.lib().int8_small_m
        expect = {k1: L, dec: L * max_new, "int8_gemm": 7 * L + vision + decode,
                  "int8_gemm/tiled": 7 * L + vision + (0 if small else decode),
                  "int8_gemm/gemv": decode if small else 0}
        print(f"  slice {name}: {B} lanes, W8A8 weights, kv_quant={stream.kv_quant} "
              f"prerotate={stream.effective_prerotate} rot_quant={stream.rot_quant}")
        prof = args.profile / f"profile_slice_{name.lower()}.txt" if args.profile else None
        by_slice[name], ms_stats[name] = phase_multistream(cfg, model, stream, B, expect, prof)
    print("  " + json.dumps({"multistream": ms_stats}))

    # G: Qwen2-VL-7B (all 28 layers, 32 vision blocks), random W8A8 weights,
    # bench.py's 7B serving defaults, through bench.py's single-stream
    # route. K5: 4 products a Qwen2-VL vision block (qkv, proj, fc1, fc2)
    if "G" in args.slices:
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
    print("  " + json.dumps({"slices": slice_stats}))

    kernels = [
        {"name": n, "route": "cuda", "source": SRC[n][0], "replaces": SRC[n][1],
         "launches": sum(c[n] for c in by_slice.values()),
         "launches_by_slice": {s: c[n] for s, c in by_slice.items()},
         **kstats[n]}
        for n in SRC if n != "int8_gemm"
    ]
    for path in ("gemv", "tiled"):  # K5's two paths, each with its own launches
        key = f"int8_gemm/{path}"
        kernels.append({"name": key, "route": "cuda", "source": SRC["int8_gemm"][0],
                        "replaces": SRC["int8_gemm"][1],
                        "launches": sum(c[key] for c in by_slice.values()),
                        "launches_by_slice": {s: c[key] for s, c in by_slice.items()},
                        **kstats["int8_gemm"][path]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
