"""mRoPE (multimodal 3D rotary position embedding) for Qwen2.5-VL.

Two halves, as in streaming_vlm_tpu/models/qwen25_vl/rope.py:

1. Host-side position *index* computation (`mrope_positions_from_ids`,
   `PosSegment`, `mrope_positions_from_segments`, `make_inv_freq`): a numpy
   copy of the JAX module's host half, held bitwise equal to it by
   tests/test_torch_host.py. (The JAX module imports jax.numpy at the top,
   so the port cannot import it on a machine without JAX.) Positions are
   float32 everywhere.

2. Device-side rotary application in torch (`mrope_angles`, `rotate_half`,
   `apply_rope`, `mrope_cos_sin`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side position index computation
# ---------------------------------------------------------------------------


def mrope_positions_from_ids(
    input_ids: np.ndarray,
    video_grid_thw: Optional[np.ndarray],
    *,
    spatial_merge_size: int,
    tokens_per_second: float,
    second_per_grid_ts: Optional[Sequence[float]],
    image_grid_thw: Optional[np.ndarray] = None,
    video_token_id: int = 151656,
    image_token_id: int = 151655,
) -> Tuple[np.ndarray, float]:
    """Scan-based 3D position assignment over a flat token sequence.

    Returns (positions [3, L] float32, mrope_delta). Mirrors the reference's
    get_rope_index (pos_emb.py:6-188): text tokens get equal (t,h,w) indices
    counting up; each vision block gets t = grid_t steps scaled by
    second_per_grid_t * tokens_per_second, h/w raster indices, all offset so
    the block starts right after the preceding text; the next text token
    starts at max(previous positions) + 1.
    """
    ids = np.asarray(input_ids).reshape(-1)
    n = ids.shape[0]
    positions = np.zeros((3, n), dtype=np.float32)

    vid_blocks = [] if video_grid_thw is None else list(np.asarray(video_grid_thw))
    img_blocks = [] if image_grid_thw is None else list(np.asarray(image_grid_thw))

    vision_tok = np.zeros(n, dtype=bool)
    vision_tok |= ids == video_token_id
    vision_tok |= ids == image_token_id

    cursor = 0  # write cursor into positions
    next_start = 0.0
    vid_i = 0
    img_i = 0
    while cursor < n:
        if not vision_tok[cursor]:
            # text run
            run_end = cursor
            while run_end < n and not vision_tok[run_end]:
                run_end += 1
            ln = run_end - cursor
            positions[:, cursor:run_end] = np.arange(ln, dtype=np.float32) + next_start
            next_start = next_start + ln
            cursor = run_end
        else:
            is_video = ids[cursor] == video_token_id
            if is_video:
                t, h, w = (int(x) for x in vid_blocks[vid_i])
                if second_per_grid_ts is not None:
                    spgt = float(second_per_grid_ts[vid_i])
                else:
                    spgt = 1.0
                vid_i += 1
            else:
                t, h, w = (int(x) for x in img_blocks[img_i])
                spgt = 0.0
                img_i += 1
            gh = h // spatial_merge_size
            gw = w // spatial_merge_size
            block = t * gh * gw
            t_idx = np.repeat(
                np.arange(t, dtype=np.float32) * spgt * tokens_per_second, gh * gw
            )
            h_idx = np.tile(np.repeat(np.arange(gh, dtype=np.float32), gw), t)
            w_idx = np.tile(np.arange(gw, dtype=np.float32), t * gh)
            pos3 = np.stack([t_idx, h_idx, w_idx]) + next_start
            positions[:, cursor : cursor + block] = pos3
            next_start = float(pos3.max()) + 1.0
            cursor += block

    delta = float(positions.max()) + 1.0 - n if n else 0.0
    return positions, delta


@dataclasses.dataclass(frozen=True)
class PosSegment:
    """A positional segment: either a text run or one vision block.

    The streaming engine tracks these explicitly instead of re-scanning
    token ids each chunk (SURVEY.md design stance 3)."""

    kind: str  # "text" | "video" | "image"
    length: int  # number of tokens (text) — ignored for vision
    grid_thw: Optional[Tuple[int, int, int]] = None
    second_per_grid_t: float = 1.0


def mrope_positions_from_segments(
    segments: Sequence[PosSegment],
    *,
    spatial_merge_size: int,
    tokens_per_second: float,
) -> np.ndarray:
    """Assign contiguous 3D positions from an explicit segment list.

    Equivalent to `mrope_positions_from_ids` on the concatenated token
    sequence, but O(#segments) instead of O(#tokens) of python-level work.
    This is what the streaming engine runs after every eviction to realise
    the reference's "shrink" contiguous re-indexing (model_forward.py:101-110)
    without per-token rescans.
    """
    chunks: List[np.ndarray] = []
    next_start = 0.0
    for seg in segments:
        if seg.kind == "text":
            ln = seg.length
            pos = np.broadcast_to(
                np.arange(ln, dtype=np.float32) + next_start, (3, ln)
            ).copy()
            next_start += ln
        else:
            t, h, w = seg.grid_thw
            gh = h // spatial_merge_size
            gw = w // spatial_merge_size
            spgt = 0.0 if seg.kind == "image" else seg.second_per_grid_t
            t_idx = np.repeat(
                np.arange(t, dtype=np.float32) * spgt * tokens_per_second, gh * gw
            )
            h_idx = np.tile(np.repeat(np.arange(gh, dtype=np.float32), gw), t)
            w_idx = np.tile(np.arange(gw, dtype=np.float32), t * gh)
            pos = np.stack([t_idx, h_idx, w_idx]) + next_start
            next_start = float(pos.max()) + 1.0
        chunks.append(pos)
    if not chunks:
        return np.zeros((3, 0), dtype=np.float32)
    return np.concatenate(chunks, axis=1)


def make_inv_freq(head_dim: int, rope_theta: float) -> np.ndarray:
    return 1.0 / (
        rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )


def mrope_angles(
    positions: torch.Tensor,  # [3, L] float32
    inv_freq: torch.Tensor,  # [head_dim // 2] float32
    mrope_section: Tuple[int, int, int],
) -> torch.Tensor:
    """Per-token rotary angles [L, head_dim // 2]: frequency channels in
    section s use the positions of axis s (t, h, w)."""
    angles3 = positions[:, :, None] * inv_freq[None, None, :]  # [3, L, F]
    s0, s1, s2 = mrope_section
    return torch.cat(
        [
            angles3[0, :, :s0],
            angles3[1, :, s0 : s0 + s1],
            angles3[2, :, s0 + s1 : s0 + s1 + s2],
        ],
        dim=-1,
    )


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor,  # [..., L, head_dim]
    cos: torch.Tensor,  # [L, head_dim // 2] (f32) or broadcastable
    sin: torch.Tensor,
) -> torch.Tensor:
    """Rotate with the duplicated-half convention (emb = cat(freqs, freqs)):
    out1 = x1*c - x2*s, out2 = x2*c + x1*s, computed in f32 and cast back
    to x's dtype."""
    h2 = x.shape[-1] // 2
    x1 = x[..., :h2].float()
    x2 = x[..., h2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mrope_cos_sin(
    positions: torch.Tensor,  # [3, L]
    inv_freq: torch.Tensor,
    mrope_section: Tuple[int, int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    ang = mrope_angles(positions.float(), inv_freq.float(), mrope_section)
    return torch.cos(ang), torch.sin(ang)
