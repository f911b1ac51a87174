"""VQA adapter: a VLMEvalKit-style chat interface over the offline model.

Port of streaming_vlm_tpu/eval/vqa.py. `VQAChat.generate(message) -> str`
is the surface VLMEvalKit (or any compatible harness) drives; MCQ answers
come from the first generated token (max_new_tokens=1), open answers from
greedy generation stopped at <|im_end|>.

Generation is KV-cached, as in the JAX package: the prompt (right-padded to
a power-of-two bucket) is prefilled through `language_forward_streaming`
over a fresh raw arena at visible length 0, and each next token is a T = 1
step of the same forward over that arena at visible length `pos_idx`, its
K/V written into the arena after it. On the card both are kernel K1 in raw
mode (the arena's K un-rotated, rotated in the kernel from the slots'
positions): the JAX function's own math, one kernel for both phases.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig


def _pow2_bucket(n: int, lo: int = 128) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@torch.no_grad()
def _prefill(tcfg, lm, embeds: torch.Tensor, slot_pos: torch.Tensor, n_real: int, arena):
    """Prompt prefill into the fresh arena (its first t_pad slots) and the
    first token's logits [V] (f32)."""
    from ..models.qwen25_vl import language

    t_pad = embeds.shape[0]
    hidden, (k_blk, _, v_blk) = language.language_forward_streaming(
        tcfg, lm, embeds, slot_pos[:, :t_pad], arena=arena, arena_positions=slot_pos,
        visible_len=0,
    )
    arena[0][:, :t_pad] = k_blk.to(arena[0].dtype)
    arena[1][:, :t_pad] = v_blk.to(arena[1].dtype)
    return language.lm_logits(tcfg, lm, hidden[n_real - 1 : n_real])[0]


@torch.no_grad()
def _decode_step(tcfg, lm, arena, slot_pos: torch.Tensor, tok: int, pos_idx: int) -> int:
    """One greedy KV-cached step: token `tok` at slot pos_idx over the
    arena's slots < pos_idx; its K/V written at pos_idx. Returns the next
    token."""
    from ..models.qwen25_vl import language

    dev = slot_pos.device
    emb = language.embed_tokens(tcfg, lm, torch.tensor([tok], dtype=torch.long, device=dev))
    hidden, (k1, _, v1) = language.language_forward_streaming(
        tcfg, lm, emb, slot_pos[:, pos_idx : pos_idx + 1], arena=arena,
        arena_positions=slot_pos, visible_len=pos_idx,
    )
    arena[0][:, pos_idx : pos_idx + 1] = k1.to(arena[0].dtype)
    arena[1][:, pos_idx : pos_idx + 1] = v1.to(arena[1].dtype)
    return int(torch.argmax(language.lm_logits(tcfg, lm, hidden)[0]))


class VQAChat:
    """message: list of {"type": "image"|"video"|"text", "value": path_or_text}.

    Video sampling mirrors the kit's Qwen2VLChat wrapper: the model is
    configured with EITHER `fps` (Video-MME_1fps, LongVideoBench_1fps style)
    or `nframe` (MVBench_64frame style: evenly spaced frames); frames are
    smart-resized to the video pixel budget and forwarded as video_pad tokens
    with video_grid_thw + second_per_grid_ts. Images are read with PIL
    (imported where used)."""

    def __init__(
        self,
        cfg: ModelConfig,
        model,
        encode: Callable[[str], List[int]],
        decode: Callable[[List[int]], str],
        *,
        max_new_tokens: int = 1,
        min_pixels: int = 100 * 28 * 28,
        max_pixels: int = 512 * 28 * 28,
        fps: Optional[float] = None,
        nframe: Optional[int] = None,
        video_min_pixels: int = 128 * 28 * 28,
        video_max_pixels: int = 768 * 28 * 28,
        system_prompt: str = "You are a helpful assistant.",
    ):
        self.cfg = cfg
        self.model = model
        self.encode = encode
        self.decode = decode
        self.max_new_tokens = max_new_tokens
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.fps = fps
        self.nframe = nframe
        self.video_min_pixels = video_min_pixels
        self.video_max_pixels = video_max_pixels
        self.system_prompt = system_prompt

    def _load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        from ..video.ingest import smart_resize

        img = Image.open(path).convert("RGB")
        w, h = img.size
        rh, rw = smart_resize(
            h, w,
            factor=self.cfg.vision.patch_size * self.cfg.vision.spatial_merge_size,
            min_pixels=self.min_pixels,
            max_pixels=self.max_pixels,
        )
        img = img.resize((rw, rh), Image.BICUBIC)
        return np.asarray(img, np.uint8)[None]  # [1, H, W, 3]

    def _load_video(self, path: str):
        """Read a clip with the native ingest reader and sample frames by
        the configured policy. Returns (patches, grid_thw, second_per_grid_t).

        fps mode: strict-FPS expected-timestamp resampling. nframe mode:
        evenly spaced frame indices (the kit's MVBench_64frame sampling),
        second_per_grid_t derived from the sampled interval."""
        from ..video import ingest

        vcfg = self.cfg.vision
        reader = ingest.VideoReader(path)
        try:
            pts = reader.frame_ts[:, 1]
            if self.fps is not None:
                idxs, _ = ingest.select_chunk_frames(
                    pts, None, None,
                    fps=self.fps, frame_factor=vcfg.temporal_patch_size,
                )
                spgt = vcfg.temporal_patch_size / self.fps
            else:
                nframe = self.nframe or 8
                n = min(nframe, reader.n_frames)
                idxs = np.linspace(0, reader.n_frames - 1, n).round().astype(int)
                idxs = idxs.tolist()
                while len(idxs) % vcfg.temporal_patch_size:
                    idxs.append(idxs[-1])
                duration = float(pts[-1]) if reader.n_frames else 1.0
                sampled_fps = len(idxs) / max(duration, 1e-6)
                spgt = vcfg.temporal_patch_size / sampled_fps
            out_h, out_w = ingest.smart_resize(
                reader.height, reader.width,
                factor=vcfg.patch_size * vcfg.spatial_merge_size,
                min_pixels=self.video_min_pixels,
                max_pixels=self.video_max_pixels,
            )
            frames = reader.fetch(idxs, out_w, out_h)
        finally:
            reader.close()
        patches, grid = ingest.patchify_frames(
            frames,
            patch_size=vcfg.patch_size,
            temporal_patch_size=vcfg.temporal_patch_size,
            merge_size=vcfg.spatial_merge_size,
        )
        return patches, grid, float(spgt)

    @torch.no_grad()
    def generate(self, message: Sequence[Dict], dataset: Optional[str] = None) -> str:
        from ..models.qwen25_vl import language
        from ..models.qwen25_vl import model as vlm
        from ..models.qwen25_vl.rope import mrope_positions_from_ids
        from ..video.ingest import patchify_frames

        cfg, tok = self.cfg, self.cfg.tokens
        pixel_parts: List[np.ndarray] = []
        grids: List = []
        video_parts: List[np.ndarray] = []
        video_grids: List = []
        spgts: List[float] = []
        body = ""
        for item in message:
            if item["type"] == "image":
                frames = self._load_image(item["value"])
                patches, grid = patchify_frames(
                    frames,
                    patch_size=cfg.vision.patch_size,
                    temporal_patch_size=cfg.vision.temporal_patch_size,
                    merge_size=cfg.vision.spatial_merge_size,
                )
                pixel_parts.append(patches)
                grids.append(grid)
                n = patches.shape[0] // cfg.vision.spatial_merge_unit
                body += f"<|vision_start|>{'<|image_pad|>' * n}<|vision_end|>"
            elif item["type"] == "video":
                patches, grid, spgt = self._load_video(item["value"])
                video_parts.append(patches)
                video_grids.append(grid)
                spgts.append(spgt)
                n = patches.shape[0] // cfg.vision.spatial_merge_unit
                body += f"<|vision_start|>{'<|video_pad|>' * n}<|vision_end|>"
            else:
                body += str(item["value"])
        assert not (pixel_parts and video_parts), (
            "mixed image+video messages are not supported by the offline "
            "forward (forward_full takes one modality's grids)"
        )
        prompt = (
            f"<|im_start|>system\n{self.system_prompt}<|im_end|>\n"
            f"<|im_start|>user\n{body}<|im_end|>\n<|im_start|>assistant\n"
        )
        ids = np.asarray(self.encode(prompt), np.int32)
        all_parts = pixel_parts or video_parts
        image_grids = np.array([list(g) for g in grids]) if grids else None
        vid_grids = np.array([list(g) for g in video_grids]) if video_grids else None

        tcfg, lm = cfg.text, self.model.text
        dev = lm.embed.weight.device
        T = len(ids)
        positions, _ = mrope_positions_from_ids(
            ids,
            vid_grids,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            tokens_per_second=cfg.vision.tokens_per_second,
            second_per_grid_ts=np.asarray(spgts) if spgts else None,
            image_grid_thw=image_grids,
            video_token_id=tok.video_pad,
            image_token_id=tok.image_pad,
        )
        t_pad = _pow2_bucket(T)
        cap = _pow2_bucket(t_pad + self.max_new_tokens)
        slot_pos = np.zeros((3, cap), np.float32)
        slot_pos[:, :T] = positions
        nxt_p = float(positions.max()) + 1.0
        slot_pos[:, T:] = nxt_p + np.arange(cap - T, dtype=np.float32)

        ids_pad = np.full(t_pad, tok.pad, np.int64)
        ids_pad[:T] = ids
        embeds = language.embed_tokens(tcfg, lm, torch.from_numpy(ids_pad).to(dev))
        if all_parts:
            w = self.model.vision.patch_embed.weight
            pixels = torch.from_numpy(np.concatenate(all_parts)).to(w.device, w.dtype)
            vis = vlm.encode_video(
                cfg, self.model, pixels,
                [tuple(int(x) for x in g) for g in (video_grids or grids)],
            )
            pad_id = tok.video_pad if video_grids else tok.image_pad
            (slots,) = np.nonzero(ids == pad_id)
            vlm.merge_vision_embeds(embeds, vis, torch.from_numpy(slots).to(dev))

        arena = language.init_kv_arena(tcfg, cap, embeds.dtype, dev)  # fresh, raw K
        sp = torch.from_numpy(slot_pos).to(dev)
        logits = _prefill(tcfg, lm, embeds, sp, T, arena)
        out: List[int] = []
        nxt = int(torch.argmax(logits))
        for i in range(self.max_new_tokens):
            if nxt == tok.im_end:
                break
            out.append(nxt)
            if len(out) == self.max_new_tokens:
                break
            nxt = _decode_step(tcfg, lm, arena, sp, nxt, T + i)
        return self.decode(out)


# ---------------------------------------------------------------------------
# Minimal VLMEvalKit-protocol MCQ runner: drives VQAChat with the kit's
# ImageMCQDataset TSV format and prompt construction (Hint / Question /
# Options / "Please select the correct answer..."), so a kit-format dataset
# runs end to end without the kit. Copies of the JAX package's runners.
# ---------------------------------------------------------------------------

MCQ_INSTRUCTION = "Please select the correct answer from the options above. \n"


def build_mcq_message(row: Dict, image_dir: str) -> List[Dict]:
    """VLMEvalKit ImageMCQDataset.build_prompt over one TSV row. The 'image'
    column holds base64 image bytes (the kit's transport format); decoded
    files are dumped under image_dir like the kit's dump_image."""
    import base64
    import os
    import string

    msgs: List[Dict] = []
    if row.get("image"):
        path = os.path.join(image_dir, f"{row['index']}.png")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(base64.b64decode(row["image"]))
        msgs.append({"type": "image", "value": path})
    elif row.get("image_path"):
        msgs.append({"type": "image", "value": row["image_path"]})

    options = {
        c: row[c]
        for c in string.ascii_uppercase
        if row.get(c) not in (None, "", "nan")
    }
    prompt = ""
    if row.get("hint") and row["hint"] != "nan":
        prompt += f"Hint: {row['hint']}\n"
    prompt += f"Question: {row['question']}\n"
    if options:
        prompt += "Options:\n"
        for k, v in options.items():
            prompt += f"{k}. {v}\n"
        prompt += MCQ_INSTRUCTION
    msgs.append({"type": "text", "value": prompt})
    return msgs


# ---------------------------------------------------------------------------
# Video-MCQ (VideoMME-format) runner: the VQA suites are video benchmarks
# (Video-MME_1fps, MVBench_64frame, LongVideoBench_1fps) driven through
# VLMEvalKit's VideoMME dataset, whose class pins its TSV to the HF download;
# this runner replicates its build_prompt byte for byte over the same TSV
# schema (video, question, candidates, answer), as the JAX package's does.
# ---------------------------------------------------------------------------

# must match vlmeval.dataset.videomme.VideoMME.{SYS, FRAMES_TMPL_NOSUB}
VIDEOMME_SYS = ""
VIDEOMME_FRAMES_TMPL_NOSUB = """
These are the frames of a video. \
Select the best answer to the following multiple-choice question based on the video. \
Respond with only the letter (A, B, C, or D) of the correct option.
"""


def build_videomme_message(row: Dict, data_root: str) -> List[Dict]:
    """VideoMME.build_prompt for a video-LLM (its video_llm=True branch):
    SYS + the video file + frames template + question with inlined
    candidates."""
    import ast
    import os

    video_path = row.get("video_path") or os.path.join(
        data_root, "video", f"{row['video']}.mp4"
    )
    cands = row["candidates"]
    if isinstance(cands, str):
        cands = ast.literal_eval(cands)
    question = row["question"] + "\n" + "\n".join(cands)
    return [
        {"type": "text", "value": VIDEOMME_SYS},
        {"type": "video", "value": video_path},
        {"type": "text", "value": VIDEOMME_FRAMES_TMPL_NOSUB},
        {"type": "text", "value": f"Question: {question}\nAnswer: "},
    ]


def run_videomme_tsv(
    chat: "VQAChat",
    tsv_path: str,
    out_path: str,
    *,
    data_root: Optional[str] = None,
    worker: int = 0,
    num_workers: int = 1,
) -> Dict[str, float]:
    """Run a VideoMME-format TSV through the chat adapter; write per-item
    predictions jsonl and return accuracy (exact-match option extraction,
    the kit's first-stage matcher)."""
    import os

    data_root = data_root or os.path.dirname(os.path.abspath(tsv_path))
    return _run_tsv(
        chat, tsv_path, out_path,
        build_message=lambda row: build_videomme_message(row, data_root),
        options_for_row=lambda row: ["A", "B", "C", "D"],
        dataset="Video-MME",
        worker=worker, num_workers=num_workers,
    )


def _run_tsv(
    chat: "VQAChat",
    tsv_path: str,
    out_path: str,
    *,
    build_message,
    options_for_row,
    dataset: str,
    worker: int = 0,
    num_workers: int = 1,
) -> Dict[str, float]:
    """Shared TSV eval loop (read rows -> worker shard -> generate ->
    exact-match option extraction -> predictions jsonl -> accuracy). The
    format runners differ only in message construction and option lists."""
    import csv
    import json

    with open(tsv_path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    n_correct, n_total = 0, 0
    with open(out_path, "w") as fout:
        for i, row in enumerate(rows):
            if i % num_workers != worker:
                continue
            pred = chat.generate(build_message(row), dataset=dataset)
            choice = extract_option(pred, options_for_row(row))
            hit = choice is not None and choice == row.get("answer")
            n_total += 1
            n_correct += int(hit)
            fout.write(
                json.dumps(
                    {
                        "index": row.get("index", i),
                        "prediction": pred,
                        "choice": choice,
                        "answer": row.get("answer"),
                        "hit": int(hit),
                    },
                    ensure_ascii=False,
                )
                + "\n"
            )
    return {"total": n_total, "correct": n_correct,
            "accuracy": n_correct / n_total if n_total else 0.0}


def extract_option(pred: str, options: Sequence[str]) -> Optional[str]:
    """Exact-match option extraction (the kit's first-stage matcher)."""
    s = pred.strip()
    if not s:
        return None
    head = s[0].upper()
    if head in options:
        return head
    for opt in options:
        if s.upper().startswith(f"{opt}.") or s.upper() == opt:
            return opt
    return None


def run_mcq_tsv(
    chat: "VQAChat",
    tsv_path: str,
    out_path: str,
    *,
    image_dir: Optional[str] = None,
    worker: int = 0,
    num_workers: int = 1,
) -> Dict[str, float]:
    """Run a VLMEvalKit-format MCQ TSV through the chat adapter; write
    per-item predictions jsonl and return accuracy."""
    import os
    import string

    image_dir = image_dir or (os.path.splitext(out_path)[0] + "_images")
    os.makedirs(image_dir, exist_ok=True)
    return _run_tsv(
        chat, tsv_path, out_path,
        build_message=lambda row: build_mcq_message(row, image_dir),
        options_for_row=lambda row: [
            c for c in string.ascii_uppercase
            if row.get(c) not in (None, "", "nan")
        ],
        dataset="MCQ",
        worker=worker, num_workers=num_workers,
    )
