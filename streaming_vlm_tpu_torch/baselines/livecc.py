"""LiveCC baseline: interleaved per-2-frame commentary with carried KV and a
threshold-gated ' ...' early stop.

Port of streaming_vlm_tpu/baselines/livecc.py over the port's
`StreamingEngine`:
  * interleaved turns: initial_fps_frames (6) first, then
    streaming_fps_frames (2) per call, the KV carried across turns;
  * the ' ...' token as streaming eos, suppressed while its probability
    <= base + step * count (the engine's `eos_threshold`);
  * 1-D RoPE for everything (LiveCC's training format: all_text=True).

LiveCC keeps ALL KV (no eviction), so window and text_round are unbounded
here. On the card each chunk's prefill is kernel K1 and each decode step
K2 (pre-rotated arena), with K5 for a W8A8 model's products.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import ModelConfig, SamplingConfig, StreamConfig
from ..streaming.engine import StreamingEngine
from ..streaming.protocol import PromptBuilder


@dataclasses.dataclass
class LiveCCConfig:
    fps: float = 2.0
    initial_fps_frames: int = 6
    streaming_fps_frames: int = 2
    max_new_tokens: int = 32
    temperature: float = 0.9
    repetition_penalty: float = 1.05
    eos_base_threshold: Optional[float] = None  # e.g. 0.0
    eos_threshold_step: Optional[float] = None  # e.g. 0.05
    kv_capacity: int = 16384


class LiveCCInfer:
    """Streaming LiveCC commentary over our engine (all_text 1-D RoPE,
    unbounded KV)."""

    def __init__(
        self,
        cfg: ModelConfig,
        model,
        encode,  # text -> List[int]
        lc: Optional[LiveCCConfig] = None,
        dtype=None,
        query: str = "Please describe the video.",
    ):
        self.cfg = cfg
        self.lc = lc or LiveCCConfig()
        stream = StreamConfig(
            fps=self.lc.fps,
            chunk_duration=self.lc.streaming_fps_frames / self.lc.fps,
            window_size=1 << 20,  # never evict vision
            text_round=1 << 20,  # never evict text
            text_sink=None,
            text_sliding_window=None,
            max_tokens_per_chunk=self.lc.max_new_tokens,
            all_text=True,  # LiveCC's 1-D RoPE
            kv_capacity=self.lc.kv_capacity,
            prefill_buckets=(128, 256, 512, 1024, 2048),
        )
        sampling = SamplingConfig(
            temperature=self.lc.temperature,
            repetition_penalty=self.lc.repetition_penalty,
            do_sample=True,
        )
        self.engine = StreamingEngine(cfg, model, stream, sampling,
                                      dtype=dtype or model.text.embed.weight.dtype)
        self.builder = PromptBuilder(cfg.tokens, encode)
        _, self.end_bias = self.builder.measure_biases()
        self.streaming_eos_id = encode(" ...")[-1]
        self.query = query
        self.round = 0
        self._elapsed_frames = 0

    def commentate(
        self, frames_u8: np.ndarray, grid: Tuple[int, int, int], decode_fn=None
    ) -> np.ndarray:
        """Feed one clip (initial or streaming window) and generate until the
        ' ...' streaming-eos (threshold-gated) or max_new_tokens."""
        merge = self.cfg.vision.spatial_merge_size
        n_vid = grid[0] * (grid[1] // merge) * (grid[2] // merge)
        # Time= labels track ELAPSED frames: round 0 consumes
        # initial_fps_frames, later rounds streaming_fps_frames each
        t0 = self._elapsed_frames / self.lc.fps
        n_clip_frames = grid[0] * self.cfg.vision.temporal_patch_size
        t1 = t0 + n_clip_frames / self.lc.fps
        self._elapsed_frames += n_clip_frames
        segs = []
        if self.round == 0:
            segs.append(self.builder.system_segment())
            segs.extend(self.builder.previous_text_segments(""))
            segs.extend(
                self.builder.user_turn_segments(
                    0, t0, t1, n_vid, grid, 1.0, query=self.query
                )
            )
        else:
            segs.extend(
                self.builder.user_turn_segments(self.round, t0, t1, n_vid, grid, 1.0)
            )
        segs.extend(self.builder.assistant_open_segments(self.round))

        thr = None
        if self.lc.eos_base_threshold is not None:
            thr = (
                int(self.streaming_eos_id),
                float(self.lc.eos_base_threshold),
                float(self.lc.eos_threshold_step or 0.0),
            )
        gen, _ = self.engine.process_chunk(
            segs,
            frames_u8=frames_u8,
            grid_thw=grid,
            eos_id=self.streaming_eos_id,
            eos_threshold=thr,
        )
        self.engine.commit_assistant(gen, self.end_bias, self.round)
        self.round += 1
        return gen
