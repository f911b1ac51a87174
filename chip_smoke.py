#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # the full run (one card)

Phases; any failure exits non-zero:

1. device: requires CUDA; prints `nvidia-smi` name and power limit.
2. build: compiles the port's kernels (streaming_vlm_tpu_torch/csrc, nvcc,
   sm_90a) into build/torch_kernels/.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the slice's shapes (bf16, Qwen2.5-VL-7B attention geometry: H=28,
   Hkv=4, hd=128, arena C=10240), with times from CUDA events.
4. reference: at 7B width (decoder cut to 4 layers), the streaming
   forward through the kernels (chunk prefill, then one decode token) in
   bf16 against the plain full-attention oracle `language_forward` in f32
   on the same random weights.
5. slice: Qwen2.5-VL-7B (random bf16 weights from a seed) served through
   `serve.streaming_inference_frames` with the default StreamConfig /
   SamplingConfig: 20 one-second chunks of 2 synthetic 476x840 frames.
   Asserts an eviction, kv <= kv_capacity, and that every K1/K2 call of
   the run went through the kernels (launch counts).

The second-to-last line is a JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# bf16 kernel vs the plain f32-math version on the same bf16 unit-normal
# inputs: both round the output to bf16; K1 also rounds the scaled q and P
# to bf16 for the tensor cores
ATOL = RTOL = 2e-2
# 7B-width streaming forward (kernels, bf16, REF_LAYERS decoder layers) vs
# the plain oracle in f32, as max |diff| of the last-token logits over max
# |oracle logit|: the kernel path may be at most REF_NOISE_FACTOR times as
# far from the f32 oracle as the plain bf16 path is (bf16 rounding of the
# residual stream and of the logits alone costs ~2e-2 here)
REF_LAYERS = 4
N_CHUNKS = 20  # slice length: past visual_round=16, so eviction runs
REF_NOISE_FACTOR = 2.0


def _median_ms(fn, reps: int = 10, batch: int = 10) -> float:
    """Median over `reps` of the mean time of `batch` back-to-back calls,
    from CUDA events (warmed up first)."""
    import torch

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


def _check(name, got, want, cases):
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = ATOL + RTOL * want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())
    e = float(err.max())
    print(f"  {name} {cases}: max_abs_err={e:.3e} (atol=rtol={ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {cases} disagrees with its plain version")
    return e


def phase_kernels():
    import torch

    from streaming_vlm_tpu_torch.ops import attention as A

    dev = "cuda"
    H, Hkv, hd, C = 28, 4, 128, 10240
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    ka, va = rn(C, Hkv, hd), rn(C, Hkv, hd)
    ang = torch.randn(C, hd // 2, generator=g, device=dev)
    acos2 = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    asin2 = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    k1_err = 0.0
    for T in (640, 64):
        q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
        for vis in (0, 4000, C - 640):
            for mode, (c2, s2) in (("prerotated", (None, None)), ("raw", (acos2, asin2))):
                out = A.streaming_prefill_attention(q, ka, va, c2, s2, ks, vs, vis)
                ref = A.prefill_attention_plain(q, ka, va, c2, s2, ks, vs, vis)
                k1_err = max(k1_err, _check("K1", out, ref, dict(T=T, visible_len=vis, mode=mode)))
    T, vis = 640, C - 640
    q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    k1_ms = _median_ms(lambda: A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, vis))
    k1_plain = _median_ms(lambda: A.prefill_attention_plain(q, ka, va, None, None, ks, vs, vis))
    print(f"  K1 T={T} visible_len={vis} prerotated: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms")

    e_delta = 20
    k2_err = 0.0
    qd = rn(H, hd)
    ksm, vsm = rn(e_delta + 1, Hkv, hd), rn(e_delta + 1, Hkv, hd)
    for vis in (0, 9000):
        for evis in (0, 7, 20):
            args = (qd, ka, va, ksm, vsm, vis, evis)
            out = A.streaming_decode_attention_full(*args, e_delta=e_delta)
            ref = A.decode_attention_plain(*args, e_delta=e_delta)
            k2_err = max(k2_err, _check("K2", out, ref, dict(visible_len=vis, extra_visible=evis)))
    args = (qd, ka, va, ksm, vsm, 9000, 7)
    k2_ms = _median_ms(lambda: A.streaming_decode_attention_full(*args, e_delta=e_delta))
    k2_plain = _median_ms(lambda: A.decode_attention_plain(*args, e_delta=e_delta))
    print(f"  K2 visible_len=9000 extra_visible=7: kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms")
    return {
        "streaming_prefill_attention": dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain),
        "streaming_decode_attention_full": dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain),
    }


def phase_reference(cfg):
    """At 7B width with the decoder cut to REF_LAYERS layers: the streaming
    forward through K1 (chunk prefill) and K2 (one decode step) in bf16
    against the plain full-attention oracle in f32 on the same weights. The
    plain oracle in bf16 is measured beside it as the bf16 noise floor."""
    import copy

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params

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

    L, Hkv, hd = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim
    ka, va = lang.init_kv_arena(tcfg, C, torch.bfloat16, dev)
    _, (_, kbr, vb) = lang.language_forward_streaming(
        tcfg, lm, emb[:T], pos[:, :T], arena=(ka, va), arena_rotated=True, visible_len=0
    )
    ka[:, :T], va[:, :T] = kbr, vb  # the pre-rotated arena holds the prefix
    dk = torch.zeros(L, E, Hkv, hd, dtype=torch.bfloat16, device=dev)
    hidden, _ = lang.language_forward_streaming(
        tcfg, lm, emb[T:], pos[:, T:], arena=(ka, va), arena_rotated=True, visible_len=T,
        extra=(dk, dk.clone()), extra_visible=0,
    )
    got = lang.lm_logits(tcfg, lm, hidden)[0]
    torch.cuda.synchronize()
    scale = oracle32.abs().max()
    err = float((got - oracle32).abs().max() / scale)
    floor = float((oracle16 - oracle32).abs().max() / scale)
    ok = (bool(torch.isfinite(got).all()) and got.shape == oracle32.shape
          and err <= REF_NOISE_FACTOR * floor)
    print(f"  last-token logits, {L} layers, T={T} prefill + 1 decode, max|diff|/max|logit| "
          f"vs the f32 oracle: kernels (bf16) {err:.3e}, plain bf16 oracle {floor:.3e} "
          f"(bound {REF_NOISE_FACTOR} x plain) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("streaming forward disagrees with the plain oracle")
    del lm, lm32
    torch.cuda.empty_cache()
    return err


def _profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _report_profile(prof, wall: float, out: Path) -> None:
    """Device time by kernel over the traced slice -> out/profile_slice.txt.
    Only device-side events count (an aten op's device time is its
    kernels')."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if t > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out.mkdir(parents=True, exist_ok=True)
    lines = [f"device busy {busy:.1f} ms of {wall * 1e3:.1f} ms wall (traced run)"]
    lines += [f"{ms:12.3f} ms {n:8d} calls  {key}" for ms, n, key in rows]
    (out / "profile_slice.txt").write_text("\n".join(lines) + "\n")
    print("  profile: " + lines[0])
    for line in lines[1:16]:
        print("   " + line[:160])


def phase_slice(cfg, model, n_chunks: int, profile: Path | None = None):
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.config import StreamConfig
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.serve import streaming_inference_frames
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer

    stream = StreamConfig()
    rng = np.random.default_rng(0)
    # 16:9 under max_pixels_for_window(16) -> grid (1, 34, 60), 510 tokens
    frames = [rng.integers(0, 256, (2, 476, 840, 3), dtype=np.uint8) for _ in range(n_chunks)]
    prof = _profiler() if profile else contextlib.nullcontext()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    with prof:
        responses, times = streaming_inference_frames(
            cfg=cfg, model=model, tokenizer=FakeTokenizer(cfg.tokens), frames=frames,
            stream=stream, time_test=True, quiet=True,
        )
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if profile:
        _report_profile(prof, wall, profile)
    launches = dict(A.launch_counts)
    for i, t in enumerate(times):
        print(f"  chunk {i:2d}: {t['gen_time_sec'] * 1e3:9.2f} ms  tokens={t['decoded_tokens']:2d}  "
              f"kv={t['kv']} (evict {t['kv_pre_evict']} -> {t['kv_post_evict']})")
    print(f"  slice: {len(times)} chunks in {wall:.3f} s; launches {launches}")
    lat = sorted(t["gen_time_sec"] * 1e3 for t in times)
    n_frames = sum(len(f) for f in frames)
    print(f"  chunk latency p50 {statistics.median(lat):.2f} ms, max {lat[-1]:.2f} ms; "
          f"ingest {n_frames / wall:.3f} frames/s")

    L = cfg.text.num_hidden_layers
    assert len(times) == n_chunks, (len(times), n_chunks)
    assert all(0 < t["decoded_tokens"] <= stream.max_tokens_per_chunk + 1 for t in times)
    assert max(max(t["kv"], t["kv_pre_evict"]) for t in times) <= stream.kv_capacity
    if n_chunks > stream.visual_round:
        assert any(
            t["kv_post_evict"] < t["kv_pre_evict"] for t in times[stream.visual_round:]
        ), "no eviction happened"
    assert launches["streaming_prefill_attention"] == L * n_chunks, launches
    assert launches["streaming_decode_attention_full"] == L * n_chunks * stream.max_tokens_per_chunk, launches
    assert all(isinstance(r["response"], str) for r in responses)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="trace the slice with torch.profiler; kernel table -> DIR/profile_slice.txt")
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
    so = _kernels.build()
    _kernels.lib()
    print(f"  {so.name}: {time.perf_counter() - t0:.2f} s (nvcc {_kernels.build_seconds} s)")

    print("[3/5] kernels vs plain versions")
    kstats = phase_kernels()

    from streaming_vlm_tpu_torch.config import qwen25_vl_7b
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params

    cfg = qwen25_vl_7b()
    print("[4/5] reference: streaming forward vs plain oracle at 7B width")
    phase_reference(cfg)

    print("[5/5] slice: streaming_inference_frames at 7B width")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.text.num_hidden_layers} layers, random bf16 weights "
          f"in {time.perf_counter() - t0:.2f} s")

    launches = phase_slice(cfg, model, N_CHUNKS, args.profile)

    src = {
        "streaming_prefill_attention": (
            "streaming_vlm_tpu_torch/csrc/prefill_attention.cu",
            "streaming_vlm_tpu/ops/attention.py:752",
        ),
        "streaming_decode_attention_full": (
            "streaming_vlm_tpu_torch/csrc/decode_attention.cu",
            "streaming_vlm_tpu/ops/attention.py:233",
        ),
    }
    kernels = [
        {"name": n, "route": "cuda", "source": src[n][0], "replaces": src[n][1],
         "launches": launches[n], **kstats[n]}
        for n in src
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
