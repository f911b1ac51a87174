"""Generic MCQ predictor: one forward, the option chosen by argmax over the
option tokens' logits at the prompt's last position.

Port of streaming_vlm_tpu/eval/mcq.py: prompts are chat-templated with a
trailing answer prefix ('Answer:'), options scored by the logit of their
single token (': X' -> its last id), no generation; data-parallel fan-out
is index round-robin over workers (`shard_indices`).

The forward is the streaming decoder's lane form with no arena
(`language.language_forward_lanes(arena=None)`): the B questions, right-
padded to one bucket T, are B lanes at visible length 0, so each layer's
attention is one launch of kernel K1 over every lane's causal block on the
card (the JAX package vmaps its plain `language_forward`; causal attention
keeps the trailing pads out of every real row either way). `lm_logits` runs
on each question's last real row alone. `models/qwen25_vl/model.forward_full`
is the oracle the tests hold it to. Vision embeddings are scattered into
each question's video_pad rows; with per-question grids (`mcq_predict_batch`
given lists) each question's tower runs on its own, then one decoder pass
serves the batch. `mcq_predict_one` is the same path at B = 1.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models.qwen25_vl import language
from ..models.qwen25_vl import model as vlm
from ..models.qwen25_vl.rope import mrope_positions_from_ids

QUESTION_POSTFIX = "\nPlease select the correct answer."
ANSWER_PREFIX = "Answer:"


def build_mcq_prompt_ids(
    cfg: ModelConfig,
    encode: Callable[[str], List[int]],
    question: str,
    n_video_tokens: int,
    *,
    question_prefix: str = "",
    question_postfix: str = QUESTION_POSTFIX,
    answer_prefix: str = ANSWER_PREFIX,
) -> np.ndarray:
    """system + user(video + question) + assistant header + answer prefix."""
    text = (
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        "<|im_start|>user\n"
        f"<|vision_start|>{'<|video_pad|>' * n_video_tokens}<|vision_end|>"
        f"{question_prefix}{question}{question_postfix}<|im_end|>\n"
        f"<|im_start|>assistant\n{answer_prefix}"
    )
    return np.asarray(encode(text), np.int32)


def option_token_ids(
    encode: Callable[[str], List[int]], options: Sequence[str], previous_str: str = ": "
) -> List[int]:
    return [encode(f"{previous_str}{o}")[-1] for o in options]


def _grid_rows(g) -> Optional[np.ndarray]:
    """A question's grids as an int [n, 3] array (None: text only)."""
    if g is None:
        return None
    g = np.asarray(g, np.int64)
    return g.reshape(-1, 3)


@torch.no_grad()
def _mcq_scores(
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    ids_list: Sequence[np.ndarray],
    option_ids_list: Sequence[Sequence[int]],
    vis_list: Sequence[Optional[torch.Tensor]],  # per question [n_vis, D] embeddings, or None
    grids_list: Sequence[Optional[np.ndarray]],  # per question [n, 3] grids, or None
    spg_list: Sequence[Optional[Sequence[float]]],  # per question second_per_grid_ts, or None
    bucket: int,
) -> torch.Tensor:
    """The option logits [B, n_opt] (f32) of B questions in one decoder
    pass: embeddings and vision scatter per question, the lanes' forward at
    visible 0 over the shared bucket T, lm_logits on each last real row."""
    B = len(ids_list)
    assert B > 0 and B == len(option_ids_list) == len(vis_list) == len(grids_list)
    n_opt = len(option_ids_list[0])
    assert all(len(o) == n_opt for o in option_ids_list)
    tok = cfg.tokens
    dev = model.text.embed.weight.device
    lens = np.asarray([len(i) for i in ids_list], np.int64)
    T = int(-(-int(lens.max()) // bucket) * bucket)
    ids = np.full((B, T), tok.pad, np.int64)
    positions = np.zeros((B, 3, T), np.float32)
    for b, row in enumerate(ids_list):
        ids[b, : len(row)] = row
        g = grids_list[b]
        spg = None if spg_list[b] is None else np.asarray(spg_list[b], np.float32).reshape(-1)
        positions[b], _ = mrope_positions_from_ids(
            ids[b], g,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            tokens_per_second=cfg.vision.tokens_per_second,
            second_per_grid_ts=spg,
            video_token_id=tok.video_pad,
            image_token_id=tok.image_pad,
        )
    embeds = language.embed_tokens(cfg.text, model.text, torch.from_numpy(ids).to(dev))
    for b, vis in enumerate(vis_list):
        if vis is None:
            continue
        (slots,) = np.nonzero(ids[b] == tok.video_pad)
        assert vis.shape[0] == len(slots), (
            f"question {b}: its grids yield {vis.shape[0]} vision tokens but the prompt has "
            f"{len(slots)} video_pad slots"
        )
        vlm.merge_vision_embeds(embeds[b], vis, torch.from_numpy(slots).to(dev))
    hidden, _ = language.language_forward_lanes(
        cfg.text, model.text, embeds, torch.from_numpy(positions).to(dev),
        arena=None, visible_len=[0] * B,
    )
    last = hidden[torch.arange(B, device=dev), torch.from_numpy(lens - 1).to(dev)]
    logits = language.lm_logits(cfg.text, model.text, last)  # [B, V] f32
    opt = torch.as_tensor(np.asarray(option_ids_list, np.int64), device=dev)
    return torch.gather(logits, 1, opt)


def _encode(cfg: ModelConfig, model: vlm.Qwen25VL, patches, grids: np.ndarray) -> torch.Tensor:
    w = model.vision.patch_embed.weight
    px = patches if isinstance(patches, torch.Tensor) else torch.from_numpy(np.asarray(patches))
    return vlm.encode_video(cfg, model, px.to(w.device, w.dtype),
                            [tuple(int(x) for x in g) for g in grids])


def mcq_predict_one(
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    ids: np.ndarray,
    option_ids: Sequence[int],
    *,
    pixel_patches=None,
    video_grid_thw=None,
    second_per_grid_ts=None,
) -> int:
    """Returns the index of the argmax option (the batched path at B = 1)."""
    grids = _grid_rows(video_grid_thw)
    vis = None if pixel_patches is None else _encode(cfg, model, pixel_patches, grids)
    scores = _mcq_scores(cfg, model, [ids], [option_ids], [vis], [grids],
                         [second_per_grid_ts], bucket=128)
    return int(torch.argmax(scores[0]))


def mcq_predict_batch(
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    ids_list: Sequence[np.ndarray],
    option_ids_list: Sequence[Sequence[int]],
    *,
    pixel_patches=None,  # [B, S, patch_dim] shared grid, or per-question list
    video_grid_thw=None,  # (t,h,w) shared by the batch, or per-question list
    second_per_grid_ts: Optional[Sequence[float]] = None,
    bucket: int = 128,
) -> List[int]:
    """Batched MCQ scoring: B questions in one decoder pass (each layer's
    attention one K1 launch over the B lanes). Prompts are right-padded to
    a shared multiple of `bucket`; each question's logits are read at its
    own last real position. Equal to mcq_predict_one per element.

    A shared grid: `video_grid_thw` one (t, h, w) and `pixel_patches`
    [B, S, patch_dim] (the batch's towers run as one call over B grids).
    Mixed grids (the OVO-Bench case: each question crops its own span):
    `video_grid_thw` a per-question list of (t, h, w) or None and
    `pixel_patches` a per-question list of [S_b, patch_dim] arrays or None
    (text-only questions); each question's tower runs on its own, and its
    rows are scattered into its video_pad slots (the JAX function's
    `vis_bucket`, the padding of those rows for its compiled executables,
    has no counterpart here)."""
    B = len(ids_list)
    assert B == len(option_ids_list) and B > 0
    mixed = isinstance(pixel_patches, list) or (
        video_grid_thw is not None
        and isinstance(video_grid_thw[0], (tuple, list, np.ndarray))
    )
    if mixed:
        return _mcq_predict_batch_mixed(cfg, model, ids_list, option_ids_list, pixel_patches,
                                        video_grid_thw, second_per_grid_ts, bucket)
    # the same pairing guards the mixed path enforces per question
    assert pixel_patches is None or video_grid_thw is not None, (
        "pixel_patches without video_grid_thw"
    )
    assert video_grid_thw is None or pixel_patches is not None, (
        "video_grid_thw without pixel_patches"
    )
    vis_list, grids_list = [None] * B, [None] * B
    if video_grid_thw is not None:
        g = _grid_rows(video_grid_thw)
        grids_list = [g] * B
        px = np.asarray(pixel_patches) if not isinstance(pixel_patches, torch.Tensor) \
            else pixel_patches
        S = px.shape[1]
        # one tower call over the B questions' grids (the same grid each)
        vis = _encode(cfg, model, px.reshape(B * S, -1), np.repeat(g, B, axis=0))
        vis_list = list(vis.view(B, -1, vis.shape[-1]).unbind(0))
    spg = [None] * B if second_per_grid_ts is None else [[s] for s in second_per_grid_ts]
    scores = _mcq_scores(cfg, model, ids_list, option_ids_list, vis_list, grids_list, spg,
                         bucket)
    return [int(x) for x in torch.argmax(scores, dim=1).tolist()]


def _mcq_predict_batch_mixed(
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    ids_list: Sequence[np.ndarray],
    option_ids_list: Sequence[Sequence[int]],
    patches_list,  # per-question Optional [S_b, patch_dim]
    grids_list,  # per-question Optional (t, h, w)
    second_per_grid_ts,  # per-question Optional float, or None
    bucket: int,
) -> List[int]:
    """Mixed-grid batched MCQ (see mcq_predict_batch): one tower call per
    question that has video, then one decoder pass for the batch."""
    B = len(ids_list)
    if patches_list is None:
        patches_list = [None] * B
    if grids_list is None:
        grids_list = [None] * B
    elif len(grids_list) == 3 and all(isinstance(x, (int, np.integer)) for x in grids_list):
        # pixel_patches came as a list but the grid is one shared (t, h, w)
        grids_list = [tuple(grids_list)] * B
    assert len(patches_list) == B and len(grids_list) == B
    vis_list, grids, spg = [], [], []
    for b in range(B):
        g = _grid_rows(grids_list[b])
        if g is None:
            assert patches_list[b] is None, "pixel_patches without grid_thw"
            vis_list.append(None)
        else:
            assert patches_list[b] is not None, "grid_thw without pixel_patches"
            vis_list.append(_encode(cfg, model, patches_list[b], g))
        grids.append(g)
        s = None if second_per_grid_ts is None else second_per_grid_ts[b]
        spg.append(None if s is None else [s])
    scores = _mcq_scores(cfg, model, ids_list, option_ids_list, vis_list, grids, spg, bucket)
    return [int(x) for x in torch.argmax(scores, dim=1).tolist()]


def shard_indices(n: int, worker: int, num_workers: int) -> List[int]:
    """Round-robin sharding of n items over num_workers."""
    return list(range(n))[worker::num_workers]
