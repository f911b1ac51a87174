"""GPT competitor generation for Inf-Stream-Eval: a frame grid + prompt to an
OpenAI-compatible vision model, producing the same chunked jsonl format as
the streaming generator.

A copy of the JAX package's streaming_vlm_tpu/eval/gpt_competitor.py (it
runs no model of the repository): frames come from the native ingest
reader and go out as JPEG data URLs (PIL); the client is injectable (tests
pass a fake), else `openai` is imported where used and needs OPENAI_KEY
(and optionally OPENAI_BASE_URL).
"""

from __future__ import annotations

import base64
import io
import json
import os
import time
from typing import List, Optional

import numpy as np

from .infstream import append_chunk, latest_end_time, load_eval_metadata, phrase_before

PROMPT = (
    "You are a live sports commentator. Based on the video frames from "
    "{t0:.0f}s to {t1:.0f}s and the prior commentary context, produce "
    "one short in-the-moment commentary line for this second of play."
)


def _frame_to_data_url(frame_u8: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame_u8).save(buf, format="JPEG", quality=80)
    return "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()


def generate_gpt_segments(
    *,
    eval_metadata: str,
    out_path: str,
    model: str = "gpt-4o-mini",
    start_time: int = 1000,
    duration: int = 100,
    seg_seconds: float = 1.0,
    frames_per_seg: int = 2,
    start_line: int = 0,
    end_line: Optional[int] = None,
    max_retries: int = 8,
    client=None,  # injectable for tests
) -> None:
    from ..video.ingest import VideoReader, select_chunk_frames

    if client is None:
        from openai import OpenAI

        api_key = os.environ.get("OPENAI_KEY") or os.environ.get("OPENAI_API_KEY")
        base = os.environ.get("OPENAI_BASE_URL")
        client = OpenAI(api_key=api_key, base_url=base) if base else OpenAI(api_key=api_key)

    for datum in load_eval_metadata(eval_metadata, start_line, end_line):
        video_path = datum["video"]
        video_name = os.path.basename(video_path)
        end_time = int(datum["content"][-1][1])
        if latest_end_time(out_path, video_name) >= end_time:
            continue
        reader = VideoReader(video_path)
        for chunk_start in range(
            max(start_time, latest_end_time(out_path, video_name)), end_time, duration
        ):
            if latest_end_time(out_path, video_name) > chunk_start:
                continue
            d = min(duration, end_time - chunk_start)
            items: List[dict] = []
            context = phrase_before(datum["content"], chunk_start)[-2000:]
            for s in np.arange(chunk_start, chunk_start + d, seg_seconds):
                idxs, _ = select_chunk_frames(
                    reader.frame_ts[:, 1], float(s), float(s + seg_seconds),
                    fps=frames_per_seg / seg_seconds, frame_factor=1,
                    only_last=frames_per_seg,
                )
                frames = reader.fetch(idxs, 448, 252)
                content = [
                    {"type": "text", "text": PROMPT.format(t0=s, t1=s + seg_seconds)
                     + "\nPrior commentary: " + context},
                ] + [
                    {"type": "image_url", "image_url": {"url": _frame_to_data_url(f)}}
                    for f in frames
                ]
                text = None
                for attempt in range(max_retries):
                    try:
                        resp = client.chat.completions.create(
                            model=model,
                            messages=[{"role": "user", "content": content}],
                            max_tokens=40,
                        )
                        text = resp.choices[0].message.content or ""
                        break
                    except Exception:
                        time.sleep(min(2**attempt, 30))
                if text is None:
                    text = ""
                items.append(
                    {"response": text.strip(), "start_time": float(s),
                     "end_time": float(s + seg_seconds)}
                )
                context = (context + " " + text)[-2000:]
            append_chunk(out_path, video_name, chunk_start, items)
