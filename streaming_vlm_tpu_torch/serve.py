"""Streaming serve loop on the PyTorch engine.

Port of streaming_vlm_tpu/serve.py (`StreamingSession`,
`streaming_inference`, `caption_clip`, `streaming_inference_from_dataset`)
for the single-stream path. Per
chunk: read + patchify the chunk's frames (prefetched on a thread) ->
prompt assembly (Time=a-bs protocol, optionally with a mid-stream
question) -> evict + chunk step on the card -> decode text -> WebVTT and
NDJSON output, with the PKV/VIDEO/INPUT/GEN/POST section timing. Chunk
i+1's vision encode is launched before the host blocks on chunk i, except
in recompute mode (efficiency config (c): the cache is dropped and the
whole surviving window re-encoded and re-prefilled every chunk), which
runs each chunk to its end first, as the JAX loop does. As in the JAX
package's loop, a chunk whose read fails ends the stream with the
responses made so far (`Error reading chunk i` on stderr), and a failed
early encode keeps the chunk's frames for its own step to encode.

Two entry points share the loop: `streaming_inference` reads a video file
through the native FFmpeg ingest library, and `streaming_inference_frames`
takes already-decoded uint8 frames (one [n, H, W, 3] array per chunk), for
machines without that library. Both take `resume_snapshot` (a
`StreamingSession.snapshot()` or `streaming.snapshot.load_snapshot` dict):
the run continues an interrupted one of the same video at the snapshot's
chunk, and the WebVTT file is appended to, not truncated. Both take
`spec_decode` (and `spec_k`): each chunk is generated by speculative
decoding with an n-gram draft (`engine.process_chunk_spec`), greedy
emitting the same tokens as the autoregressive loop; its rounds are
host-sequential, so that loop runs each chunk to its end before the next
chunk's encode (the video read still runs ahead on its thread).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig, SamplingConfig, StreamConfig, VideoConfig
from .models.qwen25_vl import model as vlm
from .streaming.engine import StreamingEngine
from .streaming.protocol import PromptBuilder, build_round_segs, hf_encode_fn
from .streaming.specdecode import NGramDraft
from .utils.profiling import SectionTimer, trace
from .utils.vtt import open_vtt, sec2ts
from .video.ingest import ChunkedVideoSource, patchify_frames, select_chunk_frames

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
        recompute: bool = False,
        spec_decode: bool = False,  # speculative decoding with an n-gram draft
        spec_k: int = 7,  # draft tokens a verify round
        dtype: Optional[torch.dtype] = None,
    ):
        if spec_decode and recompute:
            raise ValueError("spec_decode with recompute is not supported (as in the JAX package): "
                             "pick one")
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
        self.recompute = recompute
        # recompute mode: the last visual_round chunks' (patches, frames, grid)
        self._recent_videos: List[Tuple] = []
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        # the draft's statistics are not part of a snapshot (they change
        # spec decode's speed, never its tokens)
        self._draft = NGramDraft(n=2) if spec_decode else None

    def snapshot(self) -> Dict[str, Any]:
        """The live stream as a snapshot (streaming/snapshot.py): arena
        prefix, segment table, accounting, generator state. Resume in any
        process with `restore(snap)` and continue at
        `engine.chunk_index`. Recompute mode is refused: its per-window
        frames (`_recent_videos`) are not part of a snapshot, so a restored
        stream could not re-encode its window."""
        if self.recompute:
            raise ValueError("snapshot does not capture recompute mode's per-window frames; "
                             "a restored recompute stream could not re-encode its window")
        return self.engine.snapshot()

    def restore(self, snap: Dict[str, Any]) -> None:
        if self.recompute:
            raise ValueError("restore: recompute mode is not supported (see snapshot())")
        self.engine.restore(snap)

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

    def run_chunk(
        self,
        i: int,
        start_time: float,
        *,
        frames_u8=None,
        grid_thw=None,
        pixel_patches=None,
        vis_embeds=None,
        forced_response_ids: Optional[np.ndarray] = None,
        question: str = "",
        timer=None,
    ) -> Tuple[str, np.ndarray]:
        """Ingest chunk i and generate. Returns (response text, generated
        ids). `question` is a mid-stream qa injection placed after the Time
        text. With spec_decode the chunk is generated by
        `engine.process_chunk_spec` with the session's n-gram draft."""
        if self.spec_decode:
            return self._run_chunk_spec(
                i, start_time, frames_u8=frames_u8, grid_thw=grid_thw,
                pixel_patches=pixel_patches, vis_embeds=vis_embeds,
                forced_response_ids=forced_response_ids, question=question, timer=timer,
            )
        handle = self.run_chunk_async(
            i, start_time, frames_u8=frames_u8, grid_thw=grid_thw, pixel_patches=pixel_patches,
            vis_embeds=vis_embeds, question=question, timer=timer,
        )
        return self.finish_chunk(i, handle, forced_response_ids=forced_response_ids)

    def _run_chunk_spec(self, i: int, start_time: float, *, frames_u8, grid_thw, pixel_patches,
                        vis_embeds, forced_response_ids, question: str, timer):
        """run_chunk with speculative decoding (synchronous)."""
        with timer.section("INPUT") if timer else contextlib.nullcontext():
            segs = self._build_segs(i, start_time, grid_thw, question)
        gen, _ = self.engine.process_chunk_spec(
            segs, pixel_patches=pixel_patches, grid_thw=tuple(int(x) for x in grid_thw),
            frames_u8=frames_u8, vis_embeds=vis_embeds, draft_fn=self._draft,
            k_draft=self.spec_k, timer=timer,
        )
        if forced_response_ids is not None:
            # the spec path commits K/V inline; ground-truth forcing rolls it
            # back as the autoregressive path does
            self.engine.rollback_generation(len(gen))
            gen = np.asarray(forced_response_ids, np.int32)
            self.engine.append_uncached(gen)
        self._draft.observe(gen)
        self.engine.commit_assistant(gen, self.end_bias, i)
        return self._decode_text(gen), gen

    def _build_segs(self, i: int, start_time: float, grid_thw, question: str = ""):
        return build_round_segs(
            self.builder, self.stream, self.cfg.vision.spatial_merge_size,
            i, start_time, grid_thw, query=self.query, previous_text=self.previous_text,
            question=question,
        )

    def _encode_recent(self) -> torch.Tensor:
        """Recompute mode: the embeddings of the window's videos, in order."""
        e = self.engine
        parts = []
        for patches, frames, grid in self._recent_videos:
            if frames is not None:
                parts.append(vlm.encode_video_frames(self.cfg, e.model, frames, grid,
                                                     dtype=e.dtype))
            else:
                parts.append(self.encode_patches(patches, grid))
        return torch.cat(parts, dim=0)

    def run_chunk_async(
        self,
        i: int,
        start_time: float,
        *,
        frames_u8=None,
        grid_thw=None,
        pixel_patches=None,
        vis_embeds=None,
        question: str = "",
        timer=None,
    ):
        """Launch chunk i (evict + prompt + chunk step); returns the engine
        handle for finish_chunk. In recompute mode the cache is dropped and
        the window's videos (this chunk's frames or patches and those of the
        visual_round - 1 chunks before it) are encoded again."""

        def sec(name):
            return timer.section(name) if timer else contextlib.nullcontext()

        with sec("INPUT"):
            segs = self._build_segs(i, start_time, grid_thw, question)
        grid = tuple(int(x) for x in grid_thw)
        if self.recompute:
            with sec("GEN"):
                self._recent_videos.append((pixel_patches, frames_u8, grid))
                self._recent_videos = self._recent_videos[-self.stream.visual_round:]
                vis_embeds = self._encode_recent()
            pixel_patches = frames_u8 = None
        return self.engine.process_chunk_async(
            segs, pixel_patches=pixel_patches, grid_thw=grid, frames_u8=frames_u8,
            vis_embeds=vis_embeds, recompute=self.recompute, timer=timer,
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
    skip_first_chunk: float = 0,
    emit_json: bool = False,
    i_start: int = 0,  # the first chunk (a resumed stream's chunk_index)
):
    stream = session.stream
    engine = session.engine
    if output_dir is not None:
        if os.path.exists(output_dir) and i_start == 0:  # a resumed run appends
            os.remove(output_dir)
        with open_vtt(output_dir):
            pass

    responses: List[Dict] = []
    time_results: List[Dict[str, float]] = []
    timer = SectionTimer()
    # chunk i+1 is read on a thread and its vision encode is launched behind
    # chunk i's step, before the host blocks on chunk i's tokens (not in
    # recompute mode, whose chunk re-encodes its whole window itself)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(read_chunk, i_start)
        with timer.section("VIDEO"):
            first = _read_result(pending, i_start)
        pending = pool.submit(read_chunk, i_start + 1)
        cur = None if first is None else (*first, None)  # + its vision embeds
        i = i_start
        while cur is not None:
            patches, grid, embeds = cur
            start_time = (i + skip_first_chunk) * stream.chunk_duration
            with timer.section("CHECK"):
                forced = None
                if gt_lookup is not None:
                    key = f"Time={start_time:.1f}-{start_time + stream.chunk_duration:.1f}s"
                    if key in gt_lookup:
                        forced = np.asarray(
                            session.builder.encode(gt_lookup[key] + "<|im_end|>"), np.int32
                        )
            chunk_kw = dict(grid_thw=grid, pixel_patches=None if embeds is not None else patches,
                            vis_embeds=embeds, timer=timer)
            if session.spec_decode:
                # spec rounds are host-sequential: the chunk runs to its end
                # before the next chunk's encode (its read still runs ahead)
                response, gen = session.run_chunk(i, start_time, forced_response_ids=forced,
                                                  **chunk_kw)
                prefill_len = engine._spec_prefill_len
            else:
                handle = session.run_chunk_async(i, start_time, **chunk_kw)
                prefill_len = handle.n_real
            with timer.section("VIDEO"):
                nxt = _read_result(pending, i + 1)
            if nxt is not None:
                pending = pool.submit(read_chunk, i + 2)
                nxt_embeds = None
                if not session.recompute and not session.spec_decode:
                    try:
                        nxt_embeds = session.encode_patches(*nxt)
                    except Exception:  # as the JAX loop: the frames stay, and chunk
                        nxt_embeds = None  # i+1's own step encodes them (pixel_patches)
                nxt = (*nxt, nxt_embeds)
            if not session.spec_decode:
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
            if emit_json:
                sys.stdout.write(json.dumps({
                    "type": "segment",
                    "start": float(start_time),
                    "end": float(start_time + stream.chunk_duration),
                    "text": clean,
                }, ensure_ascii=False) + "\n")
                sys.stdout.flush()
            if time_test:
                section["gen_time_sec"] = loop_total
                section["decoded_tokens"] = int(len(gen))
                section["kv"] = engine.cached
                section["prefill_len"] = prefill_len  # the chunk's real prefill tokens
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
    # in chunks; a fractional value starts mid-grid (an event at 12.7 s with
    # 1 s chunks passes 12.7)
    skip_first_chunk: float = 0,
    quiet: bool = False,
    emit_json: bool = False,  # one NDJSON {"type": "segment", ...} line a chunk on stdout
    time_test: bool = False,
    gt_lookup: Optional[Dict[str, str]] = None,
    recompute: bool = False,
    spec_decode: bool = False,  # speculative decoding with an n-gram draft
    spec_k: int = 7,  # draft tokens a verify round
    resume_snapshot: Optional[Dict[str, Any]] = None,  # streaming/snapshot.py dict
    trace_dir: Optional[str] = None,  # torch.profiler Chrome trace of the whole run
    dtype: Optional[torch.dtype] = None,
):
    """Chunked streaming inference over a video file (decoded by the native
    FFmpeg ingest library). Returns the per-chunk responses, plus per-chunk
    section timings when time_test=True. `resume_snapshot` (from
    StreamingSession.snapshot() or snapshot.load_snapshot) continues an
    interrupted run of the same video and config at its chunk_index: the
    VTT is appended to and the returned lists cover the resumed chunks.
    `trace_dir` wraps the whole run in `utils.profiling.trace` (a failure
    to write the trace raises)."""
    if trace_dir is not None:
        kw = {k: v for k, v in locals().items() if k != "trace_dir"}
        with trace(trace_dir):
            return streaming_inference(trace_dir=None, **kw)
    stream = stream or StreamConfig()
    video = video or VideoConfig(fps=stream.fps)
    session = StreamingSession(
        cfg, model, tokenizer, stream=stream, sampling=sampling,
        previous_text=previous_text, query=query, recompute=recompute,
        spec_decode=spec_decode, spec_k=spec_k, dtype=dtype,
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
    i_start = _resume(session, resume_snapshot)

    def read_chunk(i: int):
        if i >= num_chunks:
            return None
        s = (i + skip_first_chunk) * stream.chunk_duration
        patches, grid, _pts = src.read_chunk(s, s + stream.chunk_duration)
        return patches, grid

    return _serve_loop(
        session, read_chunk, output_dir=output_dir, quiet=quiet, time_test=time_test,
        gt_lookup=gt_lookup, skip_first_chunk=skip_first_chunk, emit_json=emit_json,
        i_start=i_start,
    )


def _resume(session: StreamingSession, snap: Optional[Dict[str, Any]]) -> int:
    """Restore a resumed run's snapshot; the chunk to start at."""
    if snap is None:
        return 0
    session.restore(snap)
    return session.engine.chunk_index


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
    recompute: bool = False,
    spec_decode: bool = False,  # speculative decoding with an n-gram draft
    spec_k: int = 7,  # draft tokens a verify round
    resume_snapshot: Optional[Dict[str, Any]] = None,  # streaming/snapshot.py dict
    dtype: Optional[torch.dtype] = None,
):
    """Chunked streaming inference over already-decoded frames: each item of
    `frames` is one chunk's uint8 RGB frames, already sized to the pixel
    budget (H and W multiples of patch_size * merge_size). The stream ends
    when the iterable does. With `resume_snapshot`, `frames` is still the
    whole stream's: its first chunk_index items are skipped (not read into
    patches) and the run continues at the snapshot's chunk, appending to
    the VTT. Returns what `streaming_inference` returns."""
    session = StreamingSession(
        cfg, model, tokenizer, stream=stream, sampling=sampling,
        previous_text=previous_text, query=query, recompute=recompute,
        spec_decode=spec_decode, spec_k=spec_k, dtype=dtype,
    )
    i_start = _resume(session, resume_snapshot)
    it = itertools.islice(iter(frames), i_start, None)
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
        gt_lookup=gt_lookup, i_start=i_start,
    )


@torch.no_grad()
def caption_clip(
    *,
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    tokenizer,
    video_path: str,
    query: str = "Please describe the video.",
    fps: float = 1.0,
    max_frames: int = 8,
    max_new_tokens: int = 128,
    video: Optional[VideoConfig] = None,
    greedy: bool = True,
) -> str:
    """Offline full-attention captioning of a short clip: read up to
    `max_frames` frames at `fps`, then one `forward_full` per generated
    token (greedy), stopping at <|im_end|>. `greedy` is accepted as the JAX
    function accepts it; both decode greedily."""
    v = video or VideoConfig(fps=fps)
    src = ChunkedVideoSource(
        video_path,
        fps=fps,
        max_pixels=v.video_max_pixels,
        min_pixels=v.video_min_pixels,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size,
    )
    idxs, _ = select_chunk_frames(
        src.reader.frame_ts[:, 1], None, None, fps=fps,
        frame_factor=cfg.vision.temporal_patch_size, max_frames=max_frames,
    )
    frames = src.reader.fetch(idxs[:max_frames], src.out_w, src.out_h)
    patches, grid = patchify_frames(
        frames,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size,
    )
    n_vid = patches.shape[0] // cfg.vision.spatial_merge_unit
    encode = hf_encode_fn(tokenizer) if hasattr(tokenizer, "convert_tokens_to_ids") else tokenizer
    prompt = (
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        f"<|im_start|>user\n<|vision_start|>{'<|video_pad|>' * n_vid}<|vision_end|>"
        f"{query}<|im_end|>\n<|im_start|>assistant\n"
    )
    ids = np.asarray(encode(prompt), np.int32)
    w = model.vision.patch_embed.weight
    px = torch.from_numpy(patches).to(w.device, w.dtype)
    out: List[int] = []
    for _ in range(max_new_tokens):
        logits = vlm.forward_full(
            cfg, model, ids, pixel_patches=px, video_grid_thw=np.array([list(grid)]),
            second_per_grid_ts=[2.0 / fps],
        )[-1]
        nxt = int(torch.argmax(logits))
        if nxt == cfg.tokens.im_end:
            break
        out.append(nxt)
        ids = np.concatenate([ids, [nxt]]).astype(np.int32)
    if hasattr(tokenizer, "decode"):
        return tokenizer.decode(out, skip_special_tokens=True)
    return " ".join(str(t) for t in out)


def streaming_inference_from_dataset(
    *,
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    tokenizer,
    dataset,  # data.dataset.StreamDataset
    index: int,
    stream: Optional[StreamConfig] = None,
    sampling: Optional[SamplingConfig] = None,
    query: str = DEFAULT_QUERY,
    use_gt: bool = False,
    quiet: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[List[Dict], List[Dict]]:
    """Dataset-driven streaming inference (the reference's test_data_json
    mode, inference.py:244-254,333-338; the JAX package's function of the
    same name): chunks come from the dataset's synthesized turns; with
    use_gt=True each decoded round is replaced by the ground-truth text
    (teacher forcing), so cache-policy correctness is isolated from
    sampling drift. Returns (responses, ground truths), one dict a turn."""
    stream = stream or StreamConfig()
    session = StreamingSession(
        cfg, model, tokenizer, stream=stream, sampling=sampling, query=query, dtype=dtype
    )
    turns, all_frames, previous_text, _ = dataset.get_stream(index)
    session.previous_text = previous_text

    responses: List[Dict] = []
    ground_truths: List[Dict] = []
    for i, turn in enumerate(turns):
        frames = all_frames[turn.frame_indices]
        pad = (-frames.shape[0]) % cfg.vision.temporal_patch_size
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
        patches, grid = patchify_frames(
            frames,
            patch_size=cfg.vision.patch_size,
            temporal_patch_size=cfg.vision.temporal_patch_size,
            merge_size=cfg.vision.spatial_merge_size,
        )
        forced = None
        if use_gt:
            forced = np.asarray(
                session.builder.encode(turn.assistant_text + "<|im_end|>"), np.int32
            )
        response, _ = session.run_chunk(
            i, turn.start, pixel_patches=patches, grid_thw=grid,
            forced_response_ids=forced, question=turn.question,
        )
        if not quiet:
            print(f"Time={turn.start:.1f}-{turn.end:.1f}s: {response}")
        responses.append({"response": response, "start_time": turn.start, "end_time": turn.end})
        ground_truths.append(
            {"ground_truth": turn.assistant_text, "start_time": turn.start, "end_time": turn.end}
        )
    return responses, ground_truths
