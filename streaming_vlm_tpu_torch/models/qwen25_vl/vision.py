"""Qwen2-VL and Qwen2.5-VL vision towers in PyTorch.

Port of streaming_vlm_tpu/models/qwen25_vl/vision.py, both variants:
qwen2_5 (RMSNorm, SwiGLU MLP, windowed attention with full-attention
blocks at `fullatt_block_indexes`) and qwen2 (LayerNorm with bias, an
fc1 -> quick_gelu -> fc2 MLP, full attention within each temporal slice
in every block, no window reordering). The window permutation, segment ids
and 2-D rotary ids are host numpy (`vision_geometry`, a copy of the JAX
function), computed once per grid and uploaded once per device. The JAX
tower has no Pallas kernel, so attention here is plain matmul + softmax, as
the jnp code does it: dense segment-masked attention for full blocks,
batched block-diagonal attention for uniform windows, and a padded [n_win,
w_pad] batch for ragged windows. With W8A8 weights (`ops.quant.
quantize_vision`) the block and merger projections are `ops.quant.QLinear`
(kernel K5); the patch embedding stays float. `patchify_on_device` turns a
chunk's uint8 frames into normalised patches on the frames' device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import VisionConfig
from ...ops.attention import NEG_INF
from .language import RMSNorm
from .rope import apply_rope

# ---------------------------------------------------------------------------
# Host-side geometry (memoised per grid)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def vision_geometry(
    grid_thw: Tuple[Tuple[int, int, int], ...],
    window_size: int,
    spatial_merge_size: int,
    patch_size: int,
    use_windows: bool = True,
) -> Dict[str, np.ndarray]:
    """Compute, for a tuple of (t, h, w) grids, the rotary ids, window
    permutation, segment ids and (for ragged windows) the padded-batch
    gathers of Qwen2.5-VL's rot_pos_emb / get_window_index; with
    use_windows=False (qwen2) the identity permutation and one segment per
    temporal slice. Numpy copy of the JAX `vision_geometry`."""
    merge = spatial_merge_size
    unit = merge * merge
    vit_ws = window_size // merge // patch_size  # llm-grid cells per window side

    pos_list = []
    win_index_parts = []
    win_seqlens = []  # per-window token counts (in patch tokens)
    full_seqlens = []
    base = 0
    for t, h, w in grid_thw:
        gh, gw = h // merge, w // merge
        hh = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hh = hh.reshape(gh, merge, gw, merge).transpose(0, 2, 1, 3).reshape(-1)
        ww = np.broadcast_to(np.arange(w)[None, :], (h, w))
        ww = ww.reshape(gh, merge, gw, merge).transpose(0, 2, 1, 3).reshape(-1)
        p = np.stack([hh, ww], axis=-1)  # [h*w, 2]
        pos_list.append(np.tile(p, (t, 1)))

        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        pad_h = vit_ws - gh % vit_ws
        pad_w = vit_ws - gw % vit_ws
        nwh = (gh + pad_h) // vit_ws
        nww = (gw + pad_w) // vit_ws
        padded = np.full((t, gh + pad_h, gw + pad_w), -100, dtype=np.int64)
        padded[:, :gh, :gw] = idx
        padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, nwh * nww, vit_ws, vit_ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        new = flat[flat != -100]
        win_index_parts.append(new + base)
        win_seqlens.extend((seqlens * unit).tolist())
        full_seqlens.extend([h * w] * t)
        base += t * gh * gw

    pos_ids = np.concatenate(pos_list, axis=0)
    window_index = np.concatenate(win_index_parts, axis=0)
    S = pos_ids.shape[0]

    win_seqlens = [s for s in win_seqlens if s > 0]
    win_seg = np.repeat(np.arange(len(win_seqlens)), win_seqlens)
    full_seg_orig = np.repeat(np.arange(len(full_seqlens)), full_seqlens)

    if not use_windows:
        # qwen2: no window reordering; every block attends within its
        # temporal slice
        ident_units = np.arange(S // unit, dtype=np.int64)
        return {
            "pos_ids": pos_ids.astype(np.int32),
            "window_index": ident_units.astype(np.int32),
            "patch_perm": np.arange(S, dtype=np.int32),
            "win_seg": full_seg_orig.astype(np.int32),
            "full_seg": full_seg_orig.astype(np.int32),
            "reverse": ident_units.astype(np.int32),
            "seq_len": S,
            "uniform_window": 0,
        }

    unit_perm = window_index
    patch_perm = (unit_perm[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    pos_ids = pos_ids[patch_perm]
    full_seg = full_seg_orig[patch_perm]
    reverse = np.argsort(window_index)
    uniform = int(win_seqlens[0]) if len(set(win_seqlens)) == 1 else 0

    geo = {
        "pos_ids": pos_ids.astype(np.int32),
        "window_index": window_index.astype(np.int32),
        "patch_perm": patch_perm.astype(np.int32),
        "win_seg": win_seg.astype(np.int32),
        "full_seg": full_seg.astype(np.int32),
        "reverse": reverse.astype(np.int32),
        "seq_len": S,
        "uniform_window": uniform,
    }
    if not uniform:
        n_win = len(win_seqlens)
        w_pad = -(-max(win_seqlens) // 8) * 8
        offs = np.concatenate([[0], np.cumsum(win_seqlens)[:-1]]).astype(np.int64)
        pad_gather = np.zeros((n_win, w_pad), np.int32)
        pad_mask = np.zeros((n_win, w_pad), bool)
        back_gather = np.zeros(S, np.int32)
        for i, (o, ln) in enumerate(zip(offs, win_seqlens)):
            pad_gather[i, :ln] = o + np.arange(ln)
            pad_mask[i, :ln] = True
            back_gather[o : o + ln] = i * w_pad + np.arange(ln)
        geo["pad_gather"] = pad_gather.reshape(-1)
        geo["pad_mask"] = pad_mask
        geo["back_gather"] = back_gather
    return geo


def vision_rope_angles(pos_ids: np.ndarray, head_dim: int, theta: float) -> np.ndarray:
    """[S, 2] (h, w) ids -> [S, head_dim // 2] rotary angles (h-half ++ w-half)."""
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    ang = pos_ids[:, :, None].astype(np.float32) * inv_freq[None, None, :]
    return ang.reshape(pos_ids.shape[0], -1)


# CLIP normalisation constants (HF Qwen2VLImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@functools.lru_cache(maxsize=1)
def _clip_table() -> np.ndarray:
    """[256, 3] f32: each uint8 value of each channel rescaled and CLIP
    normalised with the bits of the JAX package's jitted
    `patchify_on_device`. XLA rewrites `(x / 255 - mean) / std` as one FMA
    fma(x, f32(1/255), -mean) times f32(1/std); the FMA is exact in f64
    here (x has 8 significant bits), then rounded once to f32."""
    x = np.arange(256, dtype=np.float64)[:, None]
    inv255 = np.float64(np.float32(1.0 / 255.0))
    shifted = (x * inv255 - CLIP_MEAN.astype(np.float64)).astype(np.float32)
    return shifted * (np.float32(1.0) / CLIP_STD)


_CLIP_TABLES: Dict[torch.device, torch.Tensor] = {}


def patchify_on_device(
    cfg: VisionConfig,
    frames_u8: torch.Tensor,  # [T, H, W, 3] uint8 (T divisible by temporal_patch_size)
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Rescale + CLIP normalise + Qwen2-VL patch flattening of uint8 frames
    on their own device (uint8 frames are a quarter of f32 patches' bytes
    over the host link). The normalisation is a [256, 3] table lookup,
    bitwise equal to the JAX package's jitted function. Returns [gt * gh *
    gw, C * tps * ps * ps] in out_dtype."""
    T, H, W, C = frames_u8.shape
    tps, ps, m = cfg.temporal_patch_size, cfg.patch_size, cfg.spatial_merge_size
    dev = frames_u8.device
    if dev not in _CLIP_TABLES:
        _CLIP_TABLES[dev] = torch.from_numpy(_clip_table()).to(dev)
    x = _CLIP_TABLES[dev][frames_u8.long(), torch.arange(C, device=dev)]  # [T, H, W, C] f32
    x = x.permute(0, 3, 1, 2)  # [T, C, H, W]
    gt, gh, gw = T // tps, H // ps, W // ps
    x = x.reshape(gt, tps, C, gh // m, m, ps, gw // m, m, ps)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, C * tps * ps * ps).to(out_dtype)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (mean, mean square of the centred values, rsqrt),
    as the JAX package's `layer_norm`; returns x's dtype."""
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = xc.square().mean(dim=-1, keepdim=True)
    xf = xc * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **factory))
        self.bias = nn.Parameter(torch.empty(dim, **factory))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _norm(cfg: VisionConfig, dim: int, **factory) -> nn.Module:
    if cfg.variant == "qwen2_5":
        return RMSNorm(dim, cfg.rms_norm_eps, **factory)
    return LayerNorm(dim, cfg.rms_norm_eps, **factory)


class VisionBlock(nn.Module):
    """qwen2_5: RMSNorm, SwiGLU (gate_proj, up_proj, down_proj); qwen2:
    LayerNorm, fc1 -> quick_gelu -> fc2. Both: qkv, proj."""

    def __init__(self, cfg: VisionConfig, **factory):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.norm1 = _norm(cfg, D, **factory)
        self.norm2 = _norm(cfg, D, **factory)
        self.qkv = nn.Linear(D, 3 * D, **factory)
        self.proj = nn.Linear(D, D, **factory)
        if cfg.variant == "qwen2_5":
            self.gate_proj = nn.Linear(D, I, **factory)
            self.up_proj = nn.Linear(D, I, **factory)
            self.down_proj = nn.Linear(I, D, **factory)
        else:
            self.fc1 = nn.Linear(D, I, **factory)
            self.fc2 = nn.Linear(I, D, **factory)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "fc1"):
            return self.fc2(quick_gelu(self.fc1(x)))
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, **factory):
        super().__init__()
        if cfg.variant not in ("qwen2_5", "qwen2"):
            raise ValueError(f"unknown vision variant {cfg.variant!r} (qwen2_5 or qwen2)")
        self.cfg = cfg
        D = cfg.hidden_size
        merged = D * cfg.spatial_merge_unit
        patch_in = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size**2
        self.patch_embed = nn.Linear(patch_in, D, bias=False, **factory)
        self.blocks = nn.ModuleList(VisionBlock(cfg, **factory) for _ in range(cfg.depth))
        self.ln_q = _norm(cfg, D, **factory)
        self.merger_fc1 = nn.Linear(merged, merged, **factory)
        self.merger_fc2 = nn.Linear(merged, cfg.out_hidden_size, **factory)
        self._geo: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def geometry(self, grid_thw, device: torch.device) -> Dict[str, torch.Tensor]:
        """Device copies of the grid's geometry arrays (uploaded once)."""
        key = (tuple(tuple(int(x) for x in g) for g in grid_thw), device)
        if key not in self._geo:
            v = self.cfg
            geo = vision_geometry(key[0], v.window_size, v.spatial_merge_size, v.patch_size,
                                  v.use_windows)
            ang = vision_rope_angles(geo["pos_ids"], v.head_dim, v.rope_theta)
            out = {"rope_angles": torch.from_numpy(ang).to(device)}
            for name in ("patch_perm", "reverse", "full_seg", "pad_gather", "pad_mask",
                         "back_gather"):
                if name in geo:
                    arr = geo[name]
                    t = torch.from_numpy(arr.astype(bool) if arr.dtype == bool else arr.astype(np.int64))
                    out[name] = t.to(device)
            out["uniform_window"] = int(geo["uniform_window"])
            self._geo[key] = out
        return self._geo[key]


# ---------------------------------------------------------------------------
# Attention forms
# ---------------------------------------------------------------------------


def _vision_attention(q, k, v, seg_mask):
    """q, k, v: [S, H, hd]; seg_mask: [S, S] bool."""
    S, H, hd = q.shape
    logits = torch.einsum("thd,shd->hts", q.float(), k.float()) / math.sqrt(hd)
    logits = logits.masked_fill(~seg_mask[None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("hts,shd->thd", probs, v).reshape(S, H * hd)


def _windowed_attention(q, k, v, w: int):
    """Block-diagonal attention over contiguous uniform windows of w tokens."""
    S, H, hd = q.shape
    n = S // w
    qw, kw, vw = (x.reshape(n, w, H, hd) for x in (q, k, v))
    logits = torch.einsum("nthd,nshd->nhts", qw.float(), kw.float()) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhts,nshd->nthd", probs, vw).reshape(S, H * hd)


def _padded_window_attention(q, k, v, pad_gather, pad_mask, back_gather):
    """Ragged windows as a padded [n_win, w_pad] batch with a key mask."""
    S, H, hd = q.shape
    n, w_pad = pad_mask.shape
    qw, kw, vw = (x.index_select(0, pad_gather).reshape(n, w_pad, H, hd) for x in (q, k, v))
    logits = torch.einsum("nthd,nshd->nhts", qw.float(), kw.float()) / math.sqrt(hd)
    logits = logits.masked_fill(~pad_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("nhts,nshd->nthd", probs, vw).reshape(n * w_pad, H * hd)
    return out.index_select(0, back_gather)


def vision_forward(
    cfg: VisionConfig,
    tower: VisionTower,
    pixel_patches: torch.Tensor,  # [S, in_ch * tps * ps * ps]
    geo: Dict[str, torch.Tensor],  # VisionTower.geometry(grid_thw, device)
) -> torch.Tensor:
    """Encode patches -> merged vision embeddings [S // merge_unit, out_hidden]."""
    H, hd = cfg.num_heads, cfg.head_dim
    hidden = tower.patch_embed(pixel_patches).index_select(0, geo["patch_perm"])
    cos = torch.cos(geo["rope_angles"])[:, None, :]
    sin = torch.sin(geo["rope_angles"])[:, None, :]
    full_mask = geo["full_seg"][:, None] == geo["full_seg"][None, :]
    uniform = geo["uniform_window"]
    # qwen2: every block attends within its temporal slice
    full_blocks = set(cfg.fullatt_block_indexes) if cfg.use_windows else set(range(cfg.depth))
    S = hidden.shape[0]
    for i, blk in enumerate(tower.blocks):
        x = blk.norm1(hidden)
        q, k, v = blk.qkv(x).view(S, 3, H, hd).unbind(1)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if i in full_blocks:
            attn = _vision_attention(q, k, v, full_mask)
        elif uniform:
            attn = _windowed_attention(q, k, v, uniform)
        else:
            attn = _padded_window_attention(
                q, k, v, geo["pad_gather"], geo["pad_mask"], geo["back_gather"]
            )
        hidden = hidden + blk.proj(attn)
        hidden = hidden + blk.mlp(blk.norm2(hidden))

    x = tower.ln_q(hidden).reshape(-1, cfg.spatial_merge_unit * cfg.hidden_size)
    x = tower.merger_fc2(F.gelu(tower.merger_fc1(x)))
    return x.index_select(0, geo["reverse"])
