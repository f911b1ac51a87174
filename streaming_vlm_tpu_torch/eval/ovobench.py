"""OVO-Bench harness: annotation reformatting + offline MCQ eval + grouped
accuracies.

Port of streaming_vlm_tpu/eval/ovobench.py: the task reformatting (REC /
SSR / CRR chunked by test_info realtime, the others lettered), MCQ
option scoring through `eval.mcq` (the decoder's lane form at visible 0,
kernel K1 on the card), and the Real-Time / Backward / Forward grouping.
The formatters are copies of the JAX package's (tests hold them equal).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..config import ModelConfig, VideoConfig
from .mcq import (
    build_mcq_prompt_ids,
    mcq_predict_batch,
    mcq_predict_one,
    option_token_ids,
    shard_indices,
)

REALTIME_TASKS = ("OCR", "ACR", "ATR", "STU", "FPD", "OJR")
BACKWARD_TASKS = ("EPM", "ASI", "HLD")


# ---------------------------------------------------------------------------
# Annotation reformatting
# ---------------------------------------------------------------------------


def format_crr(datum: dict) -> List[dict]:
    question = (
        "You're responsible of answering questions based on the video content. "
        "The following question are relevant to the latest frames, i.e. the end "
        f"of the video.\n\n{datum['question']}\n\nDecide whether existing visual "
        "content, especially latest frames, i.e frames that near the end of the "
        "video, provide enough information for answering the question.\n"
        'Return "Yes" if existing visual content has provided enough information;\n'
        'Return "No" otherwise.'
    )
    options = ["No", "Yes"]
    return [
        dict(
            id=datum["id"],
            task=datum["task"],
            question=question,
            video_start=datum["ask_time"],
            video_end=ti["realtime"],
            answer=options[ti["type"]],
            options=options,
            video=datum["video"],
        )
        for ti in datum["test_info"]
    ]


def format_rec(datum: dict) -> List[dict]:
    question = (
        "You're watching a video in which people may perform a certaintype of "
        "action repetitively. The person performing are referred to as 'they' in "
        "the following statement. You're task is to count how many times did "
        "different people in the video perform this kind of action in total.\n"
        "Now, answer the following question:\n\n"
        f"How many times did they {datum['activity']}?\n\n"
        "Your response type should be INT, for example, 0/1/2/3.."
    )
    options = [str(i) for i in range(11)]
    return [
        dict(
            id=datum["id"],
            task=datum["task"],
            question=question,
            video_start=0,
            video_end=ti["realtime"],
            answer=options[ti["count"]],
            options=options,
            video=datum["video"],
        )
        for ti in datum["test_info"]
    ]


def format_ssr(datum: dict) -> List[dict]:
    options = ["No", "Yes"]
    return [
        dict(
            id=datum["id"],
            task=datum["task"],
            question=(
                "You're watching a tutorial video which contain a sequential of "
                "steps. The following is one step from the whole procedures:\n\n"
                f"{ti['step']}\n\nYour task is to decide: Is the man/woman in the "
                "video currently carrying out this step?\n"
                'Return "Yes" if the man/woman in the video is currently performing this step;\n'
                'Return "No" if not.'
            ),
            video_start=0,
            video_end=ti["realtime"],
            answer=options[ti["type"]],
            options=options,
            video=datum["video"],
        )
        for ti in datum["test_info"]
    ]


def format_other(datum: dict) -> List[dict]:
    choices = ["A", "B", "C", "D", "E"]
    d = dict(datum)
    d["video_start"] = 0
    d["video_end"] = d.pop("realtime")
    opts = d.pop("options")
    d["question"] = d["question"] + "\n" + "\n".join(
        f"{choices[i]}. {o}" for i, o in enumerate(opts)
    )
    d["options"] = choices[: len(opts)]
    d["answer"] = choices[d.pop("gt")]
    return [d]


def transfer_annotations(input_path: str, output_path: str) -> int:
    """OVO-Bench json -> flat MCQ jsonl."""
    with open(input_path) as f:
        data = json.load(f)
    annos: List[dict] = []
    for datum in data:
        task = datum["task"].lower()
        fmt = {"crr": format_crr, "rec": format_rec, "ssr": format_ssr}.get(task, format_other)
        annos.extend(fmt(datum))
    with open(output_path, "w") as f:
        for a in annos:
            f.write(json.dumps(a, ensure_ascii=False) + "\n")
    return len(annos)


# ---------------------------------------------------------------------------
# Prediction + evaluation
# ---------------------------------------------------------------------------


def evaluate_ovobench(
    *,
    cfg: ModelConfig,
    model,
    encode: Callable[[str], List[int]],
    benchmark_path: str,
    video_root: str = "",
    out_path: Optional[str] = None,
    worker: int = 0,
    num_workers: int = 1,
    fps: float = 1.0,
    max_frames: int = 64,
    video: Optional[VideoConfig] = None,
    batch_size: int = 1,
) -> List[dict]:
    """Run MCQ prediction over the formatted jsonl; returns result dicts with
    per-item response/answer. Resume: items already in out_path are skipped.

    `batch_size` > 1 scores that many questions per decoder pass through
    the mixed-grid batched MCQ path (each question's video crops its own
    span, so grids differ: each question's tower runs on its own; mcq.py). Option
    lists of different lengths pad by repeating the last option id, which
    cannot change the argmax (duplicated ids share one logit and argmax
    takes the first occurrence). The same predictions as batch_size=1
    (tests/test_torch_eval_mcq.py)."""
    from ..video.ingest import ChunkedVideoSource, select_chunk_frames, patchify_frames

    video_cfg = video or VideoConfig(fps=fps)

    with open(benchmark_path) as f:
        datums = [json.loads(l) for l in f]

    done = set()
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["_idx"])
                except Exception:
                    pass

    results = []
    fout = open(out_path, "a") if out_path else None

    def emit(rec):
        results.append(rec)
        if fout:
            fout.write(json.dumps(rec, ensure_ascii=False) + "\n")
            fout.flush()

    pending: List[dict] = []  # prepared questions awaiting a batched dispatch

    def flush():
        if not pending:
            return
        if len(pending) == 1:
            p = pending[0]
            choice = mcq_predict_one(
                cfg,
                model,
                p["ids"],
                p["opt_ids"],
                pixel_patches=p["patches"],
                video_grid_thw=np.array([list(p["grid"])]),
                second_per_grid_ts=[p["spg"]],
            )
            choices = [choice]
        else:
            n_opt = max(len(p["opt_ids"]) for p in pending)
            opt_padded = [
                list(p["opt_ids"]) + [p["opt_ids"][-1]] * (n_opt - len(p["opt_ids"]))
                for p in pending
            ]
            choices = mcq_predict_batch(
                cfg,
                model,
                [p["ids"] for p in pending],
                opt_padded,
                pixel_patches=[p["patches"] for p in pending],
                video_grid_thw=[tuple(p["grid"]) for p in pending],
                second_per_grid_ts=[p["spg"] for p in pending],
            )
        for p, choice in zip(pending, choices):
            emit(
                {
                    "_idx": p["idx"],
                    "id": p["d"]["id"],
                    "task": p["d"]["task"],
                    "response": p["d"]["options"][choice],
                    "answer": p["d"]["answer"],
                }
            )
        pending.clear()

    for idx in shard_indices(len(datums), worker, num_workers):
        if idx in done:
            continue
        d = datums[idx]
        try:
            path = d["video"]
            if not os.path.exists(path):
                path = os.path.join(video_root, path)
            src = ChunkedVideoSource(
                path,
                fps=fps,
                max_pixels=video_cfg.video_max_pixels,
                min_pixels=video_cfg.video_min_pixels,
                patch_size=cfg.vision.patch_size,
                temporal_patch_size=cfg.vision.temporal_patch_size,
                merge_size=cfg.vision.spatial_merge_size,
            )
            idxs, _ = select_chunk_frames(
                src.reader.frame_ts[:, 1],
                float(d.get("video_start", 0) or 0),
                float(d["video_end"]),
                fps=fps,
                frame_factor=cfg.vision.temporal_patch_size,
                max_frames=max_frames,
            )
            frames = src.reader.fetch(idxs, src.out_w, src.out_h)
            patches, grid = patchify_frames(
                frames,
                patch_size=cfg.vision.patch_size,
                temporal_patch_size=cfg.vision.temporal_patch_size,
                merge_size=cfg.vision.spatial_merge_size,
            )
            n_vid = grid[0] * (grid[1] // cfg.vision.spatial_merge_size) * (
                grid[2] // cfg.vision.spatial_merge_size
            )
            pending.append(
                dict(
                    idx=idx,
                    d=d,
                    ids=build_mcq_prompt_ids(cfg, encode, d["question"], n_vid),
                    opt_ids=option_token_ids(encode, d["options"]),
                    patches=patches,
                    grid=grid,
                    spg=2.0 / fps,
                )
            )
        except Exception as e:
            emit({"_idx": idx, "id": d.get("id"), "task": d.get("task"), "error": str(e)})
            continue
        if len(pending) >= max(1, batch_size):
            flush()
    flush()
    if fout:
        fout.close()
    return results


def evaluate_results(results: List[dict]) -> Dict[str, float]:
    """Per-task accuracies + Real-Time / Backward / Forward group averages."""
    counts: Dict[str, Dict[str, int]] = {}
    for r in results:
        if "error" in r:
            continue
        c = counts.setdefault(r["task"], {"correct": 0, "total": 0})
        c["total"] += 1
        # exact match on the option string (a prefix match would score REC
        # response '10' as correct for answer '1'), as the JAX harness does
        if r["response"].strip() == r["answer"]:
            c["correct"] += 1
    out: Dict[str, float] = {}
    groups = {"realtime": [], "backward": [], "forward": []}
    for task, c in counts.items():
        acc = c["correct"] / c["total"]
        out[task] = acc
        if task in REALTIME_TASKS:
            groups["realtime"].append(acc)
        elif task in BACKWARD_TASKS:
            groups["backward"].append(acc)
        else:
            groups["forward"].append(acc)
    for g, accs in groups.items():
        if accs:
            out[f"avg_{g}"] = sum(accs) / len(accs)
    return out
