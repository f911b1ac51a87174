"""Inf-Stream-Eval harness.

Port of streaming_vlm_tpu/eval/infstream.py. Pipeline: generate
per-video commentary segments with crash-resume (the latest covered
end_time of each video is read back from the output jsonl) -> merge shard
outputs per video -> GPT A/B judge with position-swapped double vote ->
aggregate win rates. Generation runs the port's `serve.streaming_inference`
(on the card: K1 for each chunk's prefill, K2 or K3 for its decode steps,
K5 for a W8A8 model's products); the rest is host code copied from the JAX
harness.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional

from .judge import JudgeFn, judge_pair, tally


def load_eval_metadata(path: str, start_line: int = 0, end_line: Optional[int] = None):
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            if i < start_line:
                continue
            if end_line is not None and i >= end_line:
                break
            out.append(json.loads(line))
    return out


def latest_end_time(jsonl_path: str, video_name: str) -> int:
    """Max covered end_time for a video across both output formats."""
    latest = 0
    try:
        with open(jsonl_path) as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(obj, dict):
                    continue
                if video_name in obj and isinstance(obj[video_name], list) and obj[video_name]:
                    et = obj[video_name][-1].get("end_time", 0)
                    latest = max(latest, int(et))
                elif obj.get("video") == video_name:
                    if isinstance(obj.get("chunk_end"), (int, float)):
                        latest = max(latest, int(obj["chunk_end"]))
    except FileNotFoundError:
        pass
    return latest


def append_chunk(jsonl_path: str, video_name: str, chunk_start: int, result: List[Dict]):
    chunk_end = int(result[-1]["end_time"]) if result else int(chunk_start)
    obj = {
        "video": video_name,
        "chunk_start": int(chunk_start),
        "chunk_end": chunk_end,
        "items": result,
    }
    with open(jsonl_path, "a") as f:
        f.write(json.dumps(obj, ensure_ascii=False) + "\n")
        f.flush()
        os.fsync(f.fileno())


def phrase_before(content: List, timestamp: float) -> str:
    """ASR words with end time <= timestamp (previous-text context)."""
    words = []
    for ws, we, *rest in content:
        if timestamp >= we and rest:
            words.append(str(rest[0]).strip())
        elif timestamp < we:
            break
    return " ".join(words)


def generate_segments(
    *,
    cfg,
    model,
    tokenizer,
    eval_metadata: str,
    out_path: str,
    start_time: int = 1000,
    duration: int = 100,
    temperature: float = 0.7,
    start_line: int = 0,
    end_line: Optional[int] = None,
    query: str = "Please describe the video.",
    stream=None,
    video=None,
    dtype=None,
) -> None:
    """Chunked per-video generation with idempotent resume."""
    from ..config import SamplingConfig
    from ..serve import streaming_inference

    data_list = load_eval_metadata(eval_metadata, start_line, end_line)
    for datum in data_list:
        video_path = datum["video"]
        video_name = os.path.basename(video_path)
        end_time = int(datum["content"][-1][1])

        last = latest_end_time(out_path, video_name)
        if last >= end_time:
            print(f"skip {video_name}: already done")
            continue

        for chunk_start in range(max(start_time, last), end_time, duration):
            upto = latest_end_time(out_path, video_name)
            if upto > chunk_start:
                continue
            d = min(duration, end_time - chunk_start)
            responses = streaming_inference(
                cfg=cfg,
                model=model,
                tokenizer=tokenizer,
                video_path=video_path,
                stream=stream,
                sampling=SamplingConfig(temperature=temperature),
                video=video,
                previous_text=phrase_before(datum["content"], chunk_start),
                query=query,
                duration=d,
                skip_first_chunk=chunk_start,
                quiet=True,
                dtype=dtype,
            )
            append_chunk(out_path, video_name, chunk_start, responses)


def merge_results(shard_paths: List[str], out_path: str) -> None:
    """Merge per-chunk lines into one line per video with sorted items."""
    per_video: Dict[str, List[Dict]] = defaultdict(list)
    for p in shard_paths:
        with open(p) as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "video" in obj and "items" in obj:
                    per_video[obj["video"]].extend(obj["items"])
    with open(out_path, "w") as f:
        for video, items in per_video.items():
            items = sorted(items, key=lambda x: x["start_time"])
            f.write(
                json.dumps(
                    {
                        "video": video,
                        "chunk_start": int(items[0]["start_time"]) if items else 0,
                        "chunk_end": int(items[-1]["end_time"]) if items else 0,
                        "items": items,
                    },
                    ensure_ascii=False,
                )
                + "\n"
            )


def extract_commentary(items: List[Dict], seg_start: float, seg_end: float) -> str:
    lines = []
    for it in items:
        if seg_start <= it["start_time"] and it["end_time"] <= seg_end:
            lines.append(
                f"[{it['start_time']:.0f}-{it['end_time']:.0f}s] {it['response']}"
            )
    return "\n".join(lines)


def score_segments(
    *,
    merged_a: str,
    merged_b: str,
    eval_metadata: str,
    judge: JudgeFn,
    out_path: str,
    seg_len: int = 100,
) -> List[Dict]:
    """A/B judge every covered window; write per-window vote lines."""

    def load_merged(p):
        d = {}
        with open(p) as f:
            for line in f:
                obj = json.loads(line)
                d[os.path.basename(obj["video"])] = obj
        return d

    A = load_merged(merged_a)
    B = load_merged(merged_b)
    results = []
    with open(out_path, "w") as fout:
        for datum in load_eval_metadata(eval_metadata):
            name = os.path.basename(datum["video"])
            a_obj, b_obj = A.get(name), B.get(name)
            if not a_obj or not b_obj:
                continue
            lo = max(int(a_obj["chunk_start"]), int(b_obj["chunk_start"]))
            hi = min(int(a_obj["chunk_end"]), int(b_obj["chunk_end"]))
            for seg_start in range(lo, hi - seg_len + 1, seg_len):
                seg_end = seg_start + seg_len
                ref = phrase_before(datum["content"], seg_end)
                cand_a = extract_commentary(a_obj["items"], seg_start, seg_end)
                cand_b = extract_commentary(b_obj["items"], seg_start, seg_end)
                ab, ba = judge_pair(judge, ref, cand_a, cand_b)
                rec = {
                    "video": name,
                    "start": seg_start,
                    "end": seg_end,
                    **tally(ab, ba),
                }
                results.append(rec)
                fout.write(json.dumps(rec, ensure_ascii=False) + "\n")
    return results


def merge_scores(score_paths: List[str]) -> Dict[str, Any]:
    """Aggregate win rates."""
    wins = {"A": 0, "B": 0, "equal": 0}
    for p in score_paths:
        with open(p) as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                wins[obj["winner"]] = wins.get(obj["winner"], 0) + 1
    total = sum(wins.values())
    summary = {
        "total_windows": total,
        "wins": wins,
        "win_rate_A": wins["A"] / total if total else 0.0,
        "win_rate_B": wins["B"] / total if total else 0.0,
        "win_rate_A_excl_ties": (
            wins["A"] / (wins["A"] + wins["B"]) if wins["A"] + wins["B"] else 0.0
        ),
    }
    return summary
