"""Streaming serve loop on the PyTorch engine.

Port of streaming_vlm_tpu/serve.py (`StreamingSession`,
`streaming_inference`) for the single-stream path. Per chunk: read +
patchify the chunk's frames (prefetched on a thread) -> prompt assembly
(Time=a-bs protocol) -> evict + chunk step on the card -> decode text ->
WebVTT output, with the PKV/VIDEO/INPUT/GEN/POST section timing.
Chunk i+1's vision encode is launched before the host blocks on chunk i.
As in the JAX package's loop, a chunk whose read fails ends the stream
with the responses made so far (`Error reading chunk i` on stderr), and a
failed early encode keeps the chunk's frames for its own step to encode.

Two entry points share the loop: `streaming_inference` reads a video file
through the native FFmpeg ingest library, and `streaming_inference_frames`
takes already-decoded uint8 frames (one [n, H, W, 3] array per chunk), for
machines without that library.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig, SamplingConfig, StreamConfig, VideoConfig
from .models.qwen25_vl import model as vlm
from .streaming.engine import StreamingEngine
from .streaming.protocol import PromptBuilder, build_round_segs, hf_encode_fn
from .utils.profiling import SectionTimer
from .utils.vtt import open_vtt, sec2ts
from .video.ingest import ChunkedVideoSource, patchify_frames

DEFAULT_QUERY = "Commentate on this match"

# (pixel patches [S, patch_dim] f32, grid_thw) of one chunk, or None at the end
ChunkReader = Callable[[int], Optional[Tuple[np.ndarray, Tuple[int, int, int]]]]


class StreamingSession:
    """One live stream: engine + protocol."""

    def __init__(
        self,
        cfg: ModelConfig,
        model: vlm.Qwen25VL,
        tokenizer,  # HF tokenizer or any callable text -> List[int]
        *,
        stream: Optional[StreamConfig] = None,
        sampling: Optional[SamplingConfig] = None,
        previous_text: str = "",
        query: str = DEFAULT_QUERY,
        dtype: Optional[torch.dtype] = None,
    ):
        self.cfg = cfg
        self.stream = stream or StreamConfig()
        self.sampling = sampling or SamplingConfig()
        self.tokenizer = tokenizer
        self.engine = StreamingEngine(
            cfg, model, self.stream, self.sampling,
            dtype=dtype or model.text.embed.weight.dtype,
        )
        encode = hf_encode_fn(tokenizer) if hasattr(tokenizer, "convert_tokens_to_ids") else tokenizer
        self.builder = PromptBuilder(cfg.tokens, encode)
        self.start_bias, self.end_bias = self.builder.measure_biases()
        self.previous_text = previous_text
        self.query = query

    def _decode_text(self, ids: np.ndarray) -> str:
        if hasattr(self.tokenizer, "decode"):
            return self.tokenizer.decode([int(t) for t in ids], skip_special_tokens=True)
        return " ".join(str(int(t)) for t in ids)

    def encode_patches(self, pixel_patches: np.ndarray, grid_thw) -> torch.Tensor:
        """Launch the vision encode of a chunk (asynchronous on the card)."""
        e = self.engine
        return vlm.encode_video(
            self.cfg, e.model,
            torch.from_numpy(np.asarray(pixel_patches)).to(e.device, e.dtype),
            [tuple(int(x) for x in grid_thw)],
        )

    def _build_segs(self, i: int, start_time: float, grid_thw):
        return build_round_segs(
            self.builder, self.stream, self.cfg.vision.spatial_merge_size,
            i, start_time, grid_thw, query=self.query, previous_text=self.previous_text,
        )

    def run_chunk_async(
        self,
        i: int,
        start_time: float,
        *,
        grid_thw=None,
        pixel_patches=None,
        vis_embeds=None,
        timer=None,
    ):
        """Launch chunk i (evict + prompt + chunk step); returns the engine
        handle for finish_chunk."""
        if timer is not None:
            with timer.section("INPUT"):
                segs = self._build_segs(i, start_time, grid_thw)
        else:
            segs = self._build_segs(i, start_time, grid_thw)
        return self.engine.process_chunk_async(
            segs, pixel_patches=pixel_patches,
            grid_thw=tuple(int(x) for x in grid_thw),
            vis_embeds=vis_embeds, timer=timer,
        )

    def finish_chunk(
        self, i: int, handle, *, forced_response_ids: Optional[np.ndarray] = None
    ) -> Tuple[str, np.ndarray]:
        """Block for chunk i's generation, apply ground-truth forcing, commit
        the assistant turn. Returns (response text, generated ids)."""
        gen, _ = self.engine.finish_chunk(handle)
        if forced_response_ids is not None:
            # teacher forcing: the GT ids replace the generated turn; their
            # KV re-prefills with the next chunk
            self.engine.rollback_generation(len(gen))
            gen = np.asarray(forced_response_ids, np.int32)
            self.engine.append_uncached(gen)
        self.engine.commit_assistant(gen, self.end_bias, i)
        return self._decode_text(gen), gen


def _read_result(pending, i: int):
    """Chunk i's read (patches, grid), None at the end of the stream, or
    None after printing `Error reading chunk i` to stderr when the read
    raised: the stream then ends with the responses made so far, as the
    JAX package's loop does."""
    try:
        return pending.result()
    except Exception as e:  # the reader's own failure, whatever its type
        print(f"Error reading chunk {i}: {e}", file=sys.stderr)
        return None


def _serve_loop(
    session: StreamingSession,
    read_chunk: ChunkReader,
    *,
    output_dir: Optional[str],
    quiet: bool,
    time_test: bool,
    gt_lookup: Optional[Dict[str, str]],
):
    stream = session.stream
    engine = session.engine
    if output_dir is not None:
        if os.path.exists(output_dir):
            os.remove(output_dir)
        with open_vtt(output_dir):
            pass

    responses: List[Dict] = []
    time_results: List[Dict[str, float]] = []
    timer = SectionTimer()
    # chunk i+1 is read on a thread and its vision encode is launched behind
    # chunk i's step, before the host blocks on chunk i's tokens
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(read_chunk, 0)
        with timer.section("VIDEO"):
            first = _read_result(pending, 0)
        pending = pool.submit(read_chunk, 1)
        cur = None if first is None else (*first, None)  # + its vision embeds
        i = 0
        while cur is not None:
            patches, grid, embeds = cur
            start_time = i * stream.chunk_duration
            with timer.section("CHECK"):
                forced = None
                if gt_lookup is not None:
                    key = f"Time={start_time:.1f}-{start_time + stream.chunk_duration:.1f}s"
                    if key in gt_lookup:
                        forced = np.asarray(
                            session.builder.encode(gt_lookup[key] + "<|im_end|>"), np.int32
                        )
            handle = session.run_chunk_async(
                i, start_time, grid_thw=grid,
                pixel_patches=None if embeds is not None else patches,
                vis_embeds=embeds, timer=timer,
            )
            with timer.section("VIDEO"):
                nxt = _read_result(pending, i + 1)
            if nxt is not None:
                pending = pool.submit(read_chunk, i + 2)
                try:
                    nxt_embeds = session.encode_patches(*nxt)
                except Exception:  # as the JAX loop: the frames stay, and chunk i+1's
                    nxt_embeds = None  # own step encodes them (pixel_patches)
                nxt = (*nxt, nxt_embeds)
            response, gen = session.finish_chunk(i, handle, forced_response_ids=forced)

            with timer.section("POST"):
                clean = response[:-4] if response.endswith(" ...") else response
                responses.append(
                    {
                        "response": clean,
                        "start_time": start_time,
                        "end_time": start_time + stream.chunk_duration,
                    }
                )
            section = dict(timer.acc)
            loop_total = timer.total
            if not quiet:
                hms0 = time.strftime("%H:%M:%S", time.gmtime(int(start_time)))
                hms1 = time.strftime(
                    "%H:%M:%S", time.gmtime(int(start_time + stream.chunk_duration))
                )
                print(f"Time={hms0}-{hms1}: {response}  | kv={engine.cached}", flush=True)
                print(
                    f"[Loop {i}] total={loop_total:.3f}s | "
                    + " | ".join(f"{k}={v:.3f}s" for k, v in section.items()),
                    flush=True,
                )
            if time_test:
                section["gen_time_sec"] = loop_total
                section["decoded_tokens"] = int(len(gen))
                section["kv"] = engine.cached
                section["kv_pre_evict"] = engine.cached_before_evict
                section["kv_post_evict"] = engine.cached_after_evict
                time_results.append(section)
            if output_dir is not None:
                with open_vtt(output_dir) as vf:
                    vf.write(
                        f"{sec2ts(start_time)} --> {sec2ts(start_time + stream.chunk_duration)}\n"
                        f" Infer Time: {loop_total:.3f}s\n {response}\n\n"
                    )
            cur = nxt
            i += 1
            timer.reset()
    if time_test:
        return responses, time_results
    return responses


def streaming_inference(
    *,
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    tokenizer,
    video_path: str,
    output_dir: Optional[str] = None,
    stream: Optional[StreamConfig] = None,
    sampling: Optional[SamplingConfig] = None,
    video: Optional[VideoConfig] = None,
    previous_text: str = "",
    query: str = DEFAULT_QUERY,
    duration: Optional[float] = None,
    quiet: bool = False,
    time_test: bool = False,
    gt_lookup: Optional[Dict[str, str]] = None,
    dtype: Optional[torch.dtype] = None,
):
    """Chunked streaming inference over a video file (decoded by the native
    FFmpeg ingest library). Returns the per-chunk responses, plus per-chunk
    section timings when time_test=True."""
    stream = stream or StreamConfig()
    video = video or VideoConfig(fps=stream.fps)
    session = StreamingSession(
        cfg, model, tokenizer, stream=stream, sampling=sampling,
        previous_text=previous_text, query=query, dtype=dtype,
    )
    src = ChunkedVideoSource(
        video_path,
        fps=stream.fps,
        max_pixels=video.max_pixels_for_window(stream.window_size),
        min_pixels=video.video_min_pixels,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size,
    )
    total = duration if duration is not None else src.duration
    num_chunks = int((total + stream.chunk_duration - 1) // stream.chunk_duration)

    def read_chunk(i: int):
        if i >= num_chunks:
            return None
        s = i * stream.chunk_duration
        patches, grid, _pts = src.read_chunk(s, s + stream.chunk_duration)
        return patches, grid

    return _serve_loop(
        session, read_chunk, output_dir=output_dir, quiet=quiet, time_test=time_test,
        gt_lookup=gt_lookup,
    )


def streaming_inference_frames(
    *,
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    tokenizer,
    frames: Iterable[np.ndarray],  # one uint8 [n, H, W, 3] array per chunk
    output_dir: Optional[str] = None,
    stream: Optional[StreamConfig] = None,
    sampling: Optional[SamplingConfig] = None,
    previous_text: str = "",
    query: str = DEFAULT_QUERY,
    quiet: bool = False,
    time_test: bool = False,
    gt_lookup: Optional[Dict[str, str]] = None,
    dtype: Optional[torch.dtype] = None,
):
    """Chunked streaming inference over already-decoded frames: each item of
    `frames` is one chunk's uint8 RGB frames, already sized to the pixel
    budget (H and W multiples of patch_size * merge_size). The stream ends
    when the iterable does. Returns what `streaming_inference` returns."""
    session = StreamingSession(
        cfg, model, tokenizer, stream=stream, sampling=sampling,
        previous_text=previous_text, query=query, dtype=dtype,
    )
    it = iter(frames)
    v = cfg.vision

    def read_chunk(i: int):
        f = next(it, None)
        if f is None:
            return None
        return patchify_frames(
            np.asarray(f, np.uint8),
            patch_size=v.patch_size,
            temporal_patch_size=v.temporal_patch_size,
            merge_size=v.spatial_merge_size,
        )

    return _serve_loop(
        session, read_chunk, output_dir=output_dir, quiet=quiet, time_test=time_test,
        gt_lookup=gt_lookup,
    )
