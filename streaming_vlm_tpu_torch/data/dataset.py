"""Streaming SFT dataset: timestamped ASR streams -> interleaved streaming
turns, as token arrays ready for the train step.

A host copy of the JAX package's streaming_vlm_tpu/data/dataset.py (numpy
only, over the port's config, prompt builder, rope and video ingest
copies); tests/test_torch_dataset.py holds its examples bit for bit equal
to the JAX package's. What it mirrors of the reference recipe
(lmm_dataset.py):
  * jsonl + seek-index lazy loading (:106-121, :147-154)
  * get_phrase_before_timestamp word-stream splitting (:63-75)
  * stream-conversation synthesis: initial_fps_frames first window, then
    streaming_fps_frames per turn; 'Time=a-bs' prompts; qa_stream question
    injection; assistant text = answer + "\\n" + phrase + " ..." (:189-296)
  * previous-text turn prepended (:346-348)
  * data-level text sink+sliding-window truncation (:366-391) — the
    reference's training cut uses prev_start + sink (no +4 header offset,
    unlike inference); replicated faithfully
  * labels: -100 everywhere except assistant spans im_start+3 .. im_end (:393-405)
  * retry-on-error deterministic resampling index*13 % len (:412-422)
  * batch-size-1 collator (:424-426)

The video is read through video/ingest.py's `ChunkedVideoSource` (the
native FFmpeg reader). Output is numpy token arrays +
per-turn uint8 frames (the trainer embeds and runs the frozen ViT on the
device).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ModelConfig, VideoConfig
from ..streaming.protocol import PromptBuilder

IGNORE_INDEX = -100


def build_seek_index(annotation_path: str, seek_path: Optional[str] = None) -> str:
    """Create the <stem>_seeks.jsonl byte-offset index for a jsonl file."""
    if seek_path is None:
        root, fname = os.path.split(annotation_path)
        stem = fname.replace("_with_seeks", "").rsplit(".jsonl", 1)[0]
        seek_path = os.path.join(root, f"{stem}_seeks.jsonl")
    seeks = []
    with open(annotation_path, "rb") as f:
        off = 0
        for line in f:
            if line.strip():
                seeks.append(off)
            off += len(line)
    with open(seek_path, "w") as f:
        json.dump(seeks, f)
    return seek_path


def get_phrase_before_timestamp(
    text_stream: Sequence[Tuple[float, float, str]], timestamp: float, start_from: int = 0
) -> Tuple[str, int]:
    """Accumulate words whose END time <= timestamp (reference :63-75)."""
    phrase = ""
    i = 0
    for i, (ws, we, word) in enumerate(text_stream[start_from:]):
        if timestamp >= we:
            phrase += " " + word.strip()
            if i == len(text_stream[start_from:]) - 1:
                i += 1
                break
        else:
            break
    return phrase, i + start_from


@dataclasses.dataclass
class StreamTurn:
    """One synthesized streaming turn."""

    start: float
    end: float
    question: str
    assistant_text: str  # answer + "\n" + phrase + " ..."
    frame_indices: List[int]  # indices into the clip's sampled frames


@dataclasses.dataclass
class StreamExample:
    input_ids: np.ndarray  # [T] int32
    labels: np.ndarray  # [T] int32, -100 masked
    positions: np.ndarray  # [3, T] float32 (contiguous mRoPE)
    frames: List[np.ndarray]  # per-turn uint8 frames [t, H, W, 3]
    grids: List[Tuple[int, int, int]]
    vision_slots: np.ndarray  # [N_vis] int32 positions of video tokens
    conversation: Optional[List[Dict]] = None


def synthesize_stream_turns(
    text_stream: Sequence[Tuple[float, float, str]],
    qa_stream: Sequence[Tuple[float, float, str, str]],
    video_start: float,
    n_frames: int,
    *,
    fps: float,
    initial_fps_frames: int,
    streaming_fps_frames: int,
) -> List[StreamTurn]:
    """Turn a timestamped word stream into streaming turns (reference :218-296)."""
    qa = list(qa_stream)
    turns: List[StreamTurn] = []
    next_from = 0

    def take_qa(t0, t1):
        nonlocal qa
        if qa and t0 < qa[0][1] <= t1:
            q, a = qa[0][2], qa[0][3]
            qa = qa[1:]
            return q, a
        return "", ""

    t0, t1 = video_start, video_start + initial_fps_frames / fps
    phrase, next_from = get_phrase_before_timestamp(text_stream, t1)
    q, a = take_qa(t0, t1)
    turns.append(
        StreamTurn(
            t0, t1, q, a + "\n" + phrase + " ...",
            # clamp like the reference's clip[:initial_fps_frames] slice —
            # a clip shorter than the initial window must not IndexError
            # on the fancy-indexed frame fetch
            list(range(min(initial_fps_frames, n_frames))),
        )
    )

    for i in range(initial_fps_frames, n_frames, streaming_fps_frames):
        t0 = video_start + i / fps
        t1 = video_start + (i + streaming_fps_frames) / fps
        phrase, next_from = get_phrase_before_timestamp(text_stream, t1, next_from)
        q, a = take_qa(t0, t1)
        turns.append(
            StreamTurn(
                t0, t1, q, a + "\n" + phrase + " ...",
                list(range(i, min(i + streaming_fps_frames, n_frames))),
            )
        )
    return turns


class StreamDataset:
    """jsonl + seek-index dataset producing tokenized streaming SFT examples.

    Annotation format (reference livecc style): each line is
      [ {"role": "user", "content": [{"type": "video", "video": path,
          "video_start": s, "video_end": e, "previous": "..."} , ...]},
        {"role": "assistant", "content": [{"type": "text"|...,
          "text_stream": [[ws, we, word], ...], "qa_stream": [...] }]} ]
    """

    def __init__(
        self,
        annotation_paths: Sequence[str],
        *,
        cfg: ModelConfig,
        encode: Callable[[str], List[int]],
        video: Optional[VideoConfig] = None,
        initial_fps_frames: int = 2,
        streaming_fps_frames: int = 2,
        text_sink: int = 0,
        text_sliding_window: int = 0,
        fps_max_frames: int = 480,
        dataset_root: Optional[str] = None,
        is_eval: bool = False,
        return_conversation: bool = False,
    ):
        self.cfg = cfg
        self.builder = PromptBuilder(cfg.tokens, encode)
        self.video = video or VideoConfig()
        self.initial_fps_frames = initial_fps_frames
        self.streaming_fps_frames = streaming_fps_frames
        self.text_sink = text_sink
        self.text_sliding_window = text_sliding_window
        self.fps_max_frames = fps_max_frames
        self.dataset_root = dataset_root or os.environ.get("DATASET_PATH", "")
        self.is_eval = is_eval
        self.return_conversation = return_conversation

        self.handles: List[Tuple[str, int]] = []
        for path in annotation_paths:
            assert path.endswith(".jsonl"), "annotations must be jsonl"
            root, fname = os.path.split(path)
            stem = fname.replace("_with_seeks", "").rsplit(".jsonl", 1)[0]
            seek_path = os.path.join(root, f"{stem}_seeks.jsonl")
            if not os.path.exists(seek_path):
                build_seek_index(path, seek_path)
            with open(seek_path) as f:
                seeks = json.load(f)
            self.handles.extend(zip([path] * len(seeks), seeks))

    def __len__(self) -> int:
        return len(self.handles)

    def load_conversation(self, index: int):
        path, seek = self.handles[index]
        with open(path) as f:
            f.seek(seek)
            return json.loads(f.readline())

    def _resolve_video(self, path: str) -> str:
        if os.path.exists(path):
            return path
        joined = os.path.join(self.dataset_root, path)
        if os.path.exists(joined):
            return joined
        raise FileNotFoundError(path)

    # ------------------------------------------------------------------ core
    def get_stream(self, index: int):
        """Load and synthesize one sample's streaming turns.
        Returns (turns, all_frames [N,H,W,3] u8, previous_text, video_start)."""
        from ..video.ingest import ChunkedVideoSource, select_chunk_frames

        conversation = self.load_conversation(index)
        user_msg, assistant_msg = conversation
        video_el = user_msg["content"][0]
        assert "video" in video_el, "first user content must be the video"
        previous_text = ""
        for el in user_msg["content"]:
            if "previous" in el:
                previous_text = el["previous"]

        a0 = assistant_msg["content"][0]
        text_stream = a0["text_stream"]
        qa_stream = a0.get("qa_stream", [])

        vpath = self._resolve_video(video_el["video"])
        src = ChunkedVideoSource(
            vpath,
            fps=self.video.fps,
            max_pixels=self.video.video_max_pixels,
            min_pixels=self.video.video_min_pixels,
            patch_size=self.cfg.vision.patch_size,
            temporal_patch_size=self.cfg.vision.temporal_patch_size,
            merge_size=self.cfg.vision.spatial_merge_size,
        )
        v0 = video_el.get("video_start")
        v1 = video_el.get("video_end")
        idxs, pts = select_chunk_frames(
            src.reader.frame_ts[:, 1],
            v0,
            v1,
            fps=self.video.fps,
            frame_factor=self.video.frame_factor,
            max_frames=self.fps_max_frames,
        )
        all_frames = src.reader.fetch(idxs, src.out_w, src.out_h)
        video_start = v0 if v0 is not None else float(src.reader.frame_ts[0, 1])

        turns = synthesize_stream_turns(
            text_stream,
            qa_stream,
            video_start,
            len(all_frames),
            fps=self.video.fps,
            initial_fps_frames=self.initial_fps_frames,
            streaming_fps_frames=self.streaming_fps_frames,
        )
        return turns, all_frames, previous_text, video_start

    def getitem(self, index: int) -> StreamExample:
        turns, all_frames, previous_text, _ = self.get_stream(index)
        return self.build_example(turns, all_frames, previous_text)

    def build_example(
        self,
        turns: Sequence[StreamTurn],
        all_frames: np.ndarray,
        previous_text: str,
    ) -> StreamExample:
        tok = self.cfg.tokens
        b = self.builder
        merge = self.cfg.vision.spatial_merge_size
        tps_v = self.cfg.vision.temporal_patch_size

        from ..models.qwen25_vl.rope import PosSegment, mrope_positions_from_segments

        ids_parts: List[np.ndarray] = []
        label_parts: List[np.ndarray] = []
        pos_segs: List[PosSegment] = []
        frames_list: List[np.ndarray] = []
        grids: List[Tuple[int, int, int]] = []

        def add_text(ids: np.ndarray, labeled: bool = False):
            ids_parts.append(ids)
            label_parts.append(
                ids.copy() if labeled else np.full_like(ids, IGNORE_INDEX)
            )
            pos_segs.append(PosSegment("text", len(ids)))

        # system + previous text
        add_text(b.system_segment().ids)
        for seg in b.previous_text_segments(previous_text):
            add_text(seg.ids)

        spgt = 2.0 / self.video.fps
        for r, turn in enumerate(turns):
            frames = all_frames[turn.frame_indices]
            T = frames.shape[0]
            pad = (-T) % tps_v
            if pad:
                frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
            gt = frames.shape[0] // tps_v
            gh = frames.shape[1] // self.cfg.vision.patch_size
            gw = frames.shape[2] // self.cfg.vision.patch_size
            grid = (gt, gh, gw)
            n_vid = gt * (gh // merge) * (gw // merge)
            # user turn: round 0 concatenates the question directly after
            # the Time text (reference :242-244 'Time=...s' + f'{question}');
            # rounds r>0 use 'Time=...s {question}' — one space ALWAYS,
            # trailing even when the question is empty (reference :281).
            # Different token instance = different KV: a real checkpoint
            # trained on the reference's data sees exactly this layout.
            sep = " " if r > 0 else ""
            qtxt = turn.question
            text = (
                f"\n<|im_start|>user\n"
                f"Time={turn.start:.1f}-{turn.end:.1f}s{sep}{qtxt}"
                f"<|vision_start|>{'<|video_pad|>' * n_vid}<|vision_end|><|im_end|>"
            )
            uids = np.asarray(b.encode(text), np.int32)
            vs = int(np.nonzero(uids == tok.vision_start)[0][0])
            ve = int(np.nonzero(uids == tok.vision_end)[0][0])
            add_text(uids[:vs])
            # vision block
            ids_parts.append(uids[vs : vs + 1])
            label_parts.append(np.full(1, IGNORE_INDEX, np.int32))
            pos_segs.append(PosSegment("text", 1))
            ids_parts.append(uids[vs + 1 : ve])
            label_parts.append(np.full(ve - vs - 1, IGNORE_INDEX, np.int32))
            pos_segs.append(
                PosSegment("video", n_vid, grid_thw=grid, second_per_grid_t=spgt)
            )
            add_text(uids[ve:])
            frames_list.append(frames)
            grids.append(grid)

            # assistant turn: labels cover content + im_end
            a_open = np.asarray(b.encode("\n<|im_start|>assistant\n"), np.int32)
            add_text(a_open)
            a_body = np.asarray(
                b.encode(turn.assistant_text + "<|im_end|>"), np.int32
            )
            add_text(a_body, labeled=True)

        input_ids = np.concatenate(ids_parts).astype(np.int32)
        labels = np.concatenate(label_parts).astype(np.int32)

        # data-level sink/window truncation of previous text (reference :366-391;
        # the training arithmetic, WITHOUT the inference +4/-1 header offsets)
        if self.text_sink or self.text_sliding_window:
            from ..streaming.segments import scan_token_ranges

            p_s, p_e = scan_token_ranges(input_ids, "previous text", tok)[0]
            if p_s + self.text_sink + self.text_sliding_window <= p_e + 1:
                cut_s = p_s + self.text_sink
                cut_e = p_e - self.text_sliding_window
                keep = np.concatenate(
                    [np.arange(0, cut_s), np.arange(cut_e + 1, len(input_ids))]
                )
                input_ids = input_ids[keep]
                labels = labels[keep]
                # shrink the (all-text) position segments spanning the cut
                new_segs: List[PosSegment] = []
                acc = 0
                for ps in pos_segs:
                    s, e = acc, acc + ps.length
                    overlap = max(0, min(e, cut_e + 1) - max(s, cut_s))
                    if overlap:
                        assert ps.kind == "text", "cut must stay in text region"
                        if ps.length - overlap > 0:
                            new_segs.append(PosSegment("text", ps.length - overlap))
                    else:
                        new_segs.append(ps)
                    acc = e
                pos_segs = new_segs

        positions = mrope_positions_from_segments(
            pos_segs,
            spatial_merge_size=merge,
            tokens_per_second=self.cfg.vision.tokens_per_second,
        )
        (vision_slots,) = np.nonzero(input_ids == tok.video_pad)
        return StreamExample(
            input_ids=input_ids,
            labels=labels,
            positions=positions,
            frames=frames_list,
            grids=grids,
            vision_slots=vision_slots.astype(np.int32),
        )

    def __getitem__(self, index: int) -> StreamExample:
        # deterministic resample on error (reference :412-422), made
        # terminating AND exhaustive: index*13 % n is not a permutation in
        # general — it has fixed points (0 always; any i with 12i ≡ 0 mod n)
        # where the reference recurses forever, and short multiplicative
        # cycles (n=7: 1 -> 6 -> 1) that would exhaust the attempt budget
        # while most of the dataset is healthy. Track visited indices and
        # step +1 past ANY revisit, so n attempts provably cover n distinct
        # samples; give up only when every sample is broken.
        import sys

        n = len(self.handles)
        seen = set()
        for _ in range(n):
            seen.add(index)
            try:
                return self.getitem(index)
            except Exception as e:
                print(f"dataset: bug at index {index}: {e}", file=sys.stderr)
                if len(seen) == n:
                    break  # nothing left to try
                nxt = index * 13 % n
                while nxt in seen:
                    nxt = (nxt + 1) % n
                index = nxt
        raise RuntimeError(
            f"dataset: every resample failed ({n} distinct samples tried); "
            f"the dataset files are unreadable"
        )


def data_collator(batch: List[StreamExample]) -> StreamExample:
    assert len(batch) == 1, "batch size must be 1"
    return batch[0]


def get_ground_truth(dataset: StreamDataset, index: int) -> List[Dict]:
    """Per-round ground-truth assistant texts for GT teacher forcing
    (reference lmm_dataset.py:433-444 + inference.py:483-487)."""
    turns, _, _, _ = dataset.get_stream(index)
    return [
        {
            "ground_truth": t.assistant_text,
            "start_time": t.start,
            "end_time": t.end,
        }
        for t in turns
    ]
