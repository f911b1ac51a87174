"""Soak test: constant memory and flat latency over a long stream.

Port of streaming_vlm_tpu/eval/soak.py. The headline property of the
streaming KV policy (a constant-size cache and stable latency on an
effectively endless video): run N chunks of synthetic frames through the
engine, record the KV occupancy and each chunk's latency, and report

  * whether the occupancy stays constant (within generation-length jitter)
    once the window is saturated;
  * the steady-state latency drift: the least-squares slope of the chunk
    times, in ms per chunk, with their p50 and p95.

The engine runs where the model lives (the card unless the caller built
the model on the CPU). A chunk's time is the wall time from its launch to
its tokens on the host (the next chunk's encode is launched in between, as
the serve loop does).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import ModelConfig, SamplingConfig, StreamConfig
from ..models.qwen25_vl import model as vlm
from ..streaming.engine import StreamingEngine
from ..streaming.protocol import FakeTokenizer, PromptBuilder


@dataclasses.dataclass
class SoakReport:
    n_chunks: int
    kv_occupancy: List[int]
    chunk_seconds: List[float]
    steady_start: int
    kv_constant: bool
    latency_slope_ms_per_chunk: float
    p50_ms: float
    p95_ms: float

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["kv_occupancy"] = d["kv_occupancy"][-8:]
        d["chunk_seconds"] = [round(x, 4) for x in d["chunk_seconds"][-8:]]
        return json.dumps(d)


def run_soak(
    *,
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    stream: StreamConfig,
    sampling: Optional[SamplingConfig] = None,
    n_chunks: int = 100,
    grid=(1, 8, 8),
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    tokenizer=None,
) -> SoakReport:
    """Drive the engine with synthetic uint8 frames for n_chunks; measure."""
    sampling = sampling or SamplingConfig()
    adt = dtype or model.text.embed.weight.dtype
    engine = StreamingEngine(cfg, model, stream, sampling, dtype=adt)
    engine.prewarm()
    builder = PromptBuilder(cfg.tokens, tokenizer or FakeTokenizer(cfg.tokens))
    _, end_bias = builder.measure_biases()
    rng = np.random.default_rng(seed)

    merge = cfg.vision.spatial_merge_size
    n_vid = grid[0] * (grid[1] // merge) * (grid[2] // merge)
    spgt = 2.0 / stream.fps
    shape = (grid[0] * cfg.vision.temporal_patch_size, grid[1] * cfg.vision.patch_size,
             grid[2] * cfg.vision.patch_size, 3)

    def encode_next():
        frames = rng.integers(0, 255, size=shape, dtype=np.uint8)
        return vlm.encode_video_frames(cfg, model, engine.upload_frames(frames), grid, dtype=adt)

    # the serve loop's order: launch chunk i's step, then chunk i+1's encode,
    # then block on chunk i's tokens
    kv_occ, times = [], []
    vis = encode_next()
    for i in range(n_chunks):
        t0, t1 = i * stream.chunk_duration, (i + 1) * stream.chunk_duration
        segs = []
        if i == 0:
            segs.append(builder.system_segment())
            segs.extend(builder.previous_text_segments("soak"))
            segs.extend(builder.user_turn_segments(0, t0, t1, n_vid, grid, spgt, query="go"))
        else:
            segs.extend(builder.user_turn_segments(i, t0, t1, n_vid, grid, spgt))
        segs.extend(builder.assistant_open_segments(i))
        t_start = time.perf_counter()
        handle = engine.process_chunk_async(segs, vis_embeds=vis, grid_thw=grid)
        if i + 1 < n_chunks:
            vis = encode_next()
        gen, _ = engine.finish_chunk(handle)
        times.append(time.perf_counter() - t_start)
        engine.commit_assistant(gen, end_bias, i)
        kv_occ.append(engine.cached)

    # the steady state starts once both the round windows and the previous-
    # text sink / sliding window have filled: the last third of the run, but
    # no earlier than the round windows
    steady_start = max(max(stream.visual_round, stream.text_round) + 2, 2 * n_chunks // 3)
    steady_kv = kv_occ[steady_start:]
    steady_t = np.asarray(times[steady_start:])
    # the occupancy moves only by generation-length jitter (<= max_new) and
    # the slowly growing digit count of the 'Time=a-bs' prompts: bounded
    kv_constant = (
        len(steady_kv) > 0
        and max(steady_kv) - min(steady_kv)
        <= stream.max_tokens_per_chunk + 8 * stream.text_round // 4 + 8
    )
    slope = 0.0
    if len(steady_t) >= 3:
        slope = float(np.polyfit(np.arange(len(steady_t)), steady_t * 1000.0, 1)[0])
    return SoakReport(
        n_chunks=n_chunks,
        kv_occupancy=kv_occ,
        chunk_seconds=times,
        steady_start=steady_start,
        kv_constant=kv_constant,
        latency_slope_ms_per_chunk=slope,
        p50_ms=float(np.median(steady_t) * 1000) if len(steady_t) else 0.0,
        p95_ms=float(np.percentile(steady_t, 95) * 1000) if len(steady_t) else 0.0,
    )
