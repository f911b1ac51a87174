"""Efficiency benchmark: the paper's four attention-policy configurations.

Port of streaming_vlm_tpu/eval/efficiency.py (parity target: the
reference's eval/efficiency/efficiency_test.py):

  (a) full attention           (window 100000, no sink / sliding window)
  (b) non-overlapping window   (window 100, no sink / sliding window)
  (c) overlapping + recompute  (window 16, the cache recomputed every chunk)
  (d) StreamingVLM             (window 16, sink 512 + sliding window 512)

The JSON it writes has the reference's schema (meta / per_chunk /
summary), with each chunk's gen_time_sec, decoded_tokens and
gen_time_per_token; the decoded-token counts come from the port's
`serve.streaming_inference` (time_test=True), which runs where the model
lives (the card unless the caller built the model on the CPU).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig, SamplingConfig, StreamConfig, VideoConfig
from ..models.qwen25_vl import model as vlm

DEFAULTS = StreamConfig()

CONFIGS: Dict[str, Dict[str, Any]] = {
    "a": dict(  # full attention
        window_size=100000, text_round=100000, text_sink=None,
        text_sliding_window=None, recompute=False,
    ),
    "b": dict(  # sliding window without overlap
        window_size=100, text_round=100, text_sink=None,
        text_sliding_window=None, recompute=False,
    ),
    "c": dict(  # sliding window with overlap (recompute)
        window_size=DEFAULTS.window_size, text_round=DEFAULTS.text_round,
        text_sink=None, text_sliding_window=None, recompute=True,
    ),
    "d": dict(  # StreamingVLM
        window_size=DEFAULTS.window_size, text_round=DEFAULTS.text_round,
        text_sink=DEFAULTS.text_sink, text_sliding_window=DEFAULTS.text_sliding_window,
        recompute=False,
    ),
}


def kv_capacity_for(window_size: int, duration: float, tokens_per_chunk: int) -> int:
    """Arena capacity of a configuration: the bounded ones hold their
    window, configuration (a) the whole stream."""
    n = int(min(window_size, duration) * tokens_per_chunk * 1.2) + 4096
    return ((n + 511) // 512) * 512


def run_efficiency(
    *,
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    tokenizer,
    video_path: str,
    baseline_mode: str = "d",
    duration: float = 1000.0,
    previous_text: str = "",
    temperature: float = 0.9,
    pos_mode: str = "shrink",
    all_text: bool = False,
    output_dir: str = "output/efficiency",
    model_name: str = "streaming-vlm-tpu",
    stream_overrides: Optional[Dict[str, Any]] = None,
    video: Optional[VideoConfig] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Serve `duration` seconds of `video_path` under configuration
    `baseline_mode` and write the reference's efficiency JSON into
    output_dir. Returns its payload."""
    from ..serve import streaming_inference

    c = dict(CONFIGS[baseline_mode])
    recompute = c.pop("recompute")
    tokens_per_chunk = 560  # default operating point estimate (512 vision + text)
    stream_kw = dict(
        chunk_duration=DEFAULTS.chunk_duration,
        pos_mode=pos_mode,
        all_text=all_text,
        max_tokens_per_chunk=DEFAULTS.max_tokens_per_chunk,
        **c,
    )
    if stream_overrides:
        stream_kw.update(stream_overrides)
    # sized after the overrides: a wider window needs a wider arena
    stream_kw.setdefault(
        "kv_capacity", kv_capacity_for(stream_kw["window_size"], duration, tokens_per_chunk))
    stream = StreamConfig(**stream_kw)

    _, timings = streaming_inference(
        cfg=cfg, model=model, tokenizer=tokenizer, video_path=video_path, stream=stream,
        sampling=SamplingConfig(temperature=temperature), video=video,
        previous_text=previous_text, duration=duration, quiet=False, time_test=True,
        recompute=recompute, dtype=dtype,
    )

    records = []
    for i, sec in enumerate(timings):
        # the chunk's whole loop wall time (the GEN section alone undercounts
        # pipelined chunks, whose wait lands at the next chunk's encode)
        gen_t = float(sec.get("gen_time_sec", sec.get("GEN", 0.0)))
        dec = int(sec.get("decoded_tokens", 0))
        records.append({
            "chunk_index": i,
            "time_start_sec": i * stream.chunk_duration,
            "video_len_sec": (i + 1) * stream.chunk_duration,
            "gen_time_sec": gen_t,
            "decoded_tokens": dec,
            "gen_time_per_token": (gen_t / dec) if dec > 0 else None,
        })
    mode_name = {"a": "baseline_a", "b": "baseline_b", "c": "baseline_c",
                 "d": "streaming"}[baseline_mode]
    meta = {
        "timestamp": datetime.now().strftime("%Y%m%d-%H%M%S"),
        "model_path": model_name,
        "video_path": video_path,
        "pos_mode": pos_mode,
        "all_text": all_text,
        "temperature": temperature,
        "mode": mode_name,
        "window_size": stream.window_size,
        "chunk_duration": stream.chunk_duration,
        "text_round": stream.text_round,
        "text_sink": stream.text_sink,
        "text_sliding_window": stream.text_sliding_window,
        "recompute": recompute,
        "duration_tested_sec": duration,
    }
    n = len(records)
    per_tok = [r["gen_time_per_token"] for r in records if r["gen_time_per_token"]]
    payload = {
        "meta": meta,
        "per_chunk": records,
        "summary": {
            "num_chunks": n,
            "avg_gen_time_sec": float(sum(r["gen_time_sec"] for r in records) / max(n, 1)),
            "avg_gen_time_per_token": float(sum(per_tok) / max(len(per_tok), 1)),
        },
    }
    os.makedirs(output_dir, exist_ok=True)

    def safe(x):
        return str(x).replace("/", "_").replace(" ", "_")

    name = (
        f"{mode_name}__{safe(model_name)}__{safe(os.path.basename(video_path))}"
        f"__w{stream.window_size}__c{stream.chunk_duration}__t{stream.text_round}"
        f"__{meta['timestamp']}.json"
    )
    path = os.path.join(output_dir, name)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, ensure_ascii=False, indent=2)
    print(f"[OK] saved efficiency json -> {path}")
    return payload
