"""Weight bridge: the JAX package's parameter pytree -> the port's modules.

The only code that knows the JAX layout (models/qwen25_vl/language.py and
vision.py `init_*_params`): decoder and vision-block weights are stacked
along a leading [L, ...] axis and matrices are stored [in, out]. Here the
layer axis is unstacked and matrices are transposed into nn.Linear's
[out, in]. Input leaves are numpy arrays (np.asarray of the JAX arrays), so
this module never imports jax.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from .qwen25_vl.model import Qwen25VL

_TEXT_LAYER = {  # port submodule attr -> (JAX weight key, JAX bias key or None)
    "q_proj": ("q_w", "q_b"),
    "k_proj": ("k_w", "k_b"),
    "v_proj": ("v_w", "v_b"),
    "o_proj": ("o_w", None),
    "gate_proj": ("gate_w", None),
    "up_proj": ("up_w", None),
    "down_proj": ("down_w", None),
}
_VISION_BLOCK = {
    "qkv": ("qkv_w", "qkv_b"),
    "proj": ("proj_w", "proj_b"),
    "gate_proj": ("gate_w", "gate_b"),
    "up_proj": ("up_w", "up_b"),
    "down_proj": ("down_w", "down_b"),
}


def _set(p: torch.Tensor, arr: np.ndarray) -> None:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"shape mismatch: JAX {a.shape} vs port {tuple(p.shape)}")
    p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def _linear(lin: nn.Linear, w: np.ndarray, b=None) -> None:
    _set(lin.weight, np.asarray(w).T)
    if b is not None:
        _set(lin.bias, b)


@torch.no_grad()
def from_jax_params(
    cfg: ModelConfig, params: Dict[str, Any], *, device="cuda", dtype=torch.float32
) -> Qwen25VL:
    """Build the port's model from a JAX `model.init_params` pytree (leaves
    as numpy arrays or anything np.asarray accepts), on the card unless the
    caller passes device="cpu"."""
    with torch.device("meta"):
        m = Qwen25VL(cfg, dtype=dtype)
    m.to_empty(device=device)

    t, lm = params["text"], m.text
    _set(lm.embed.weight, t["embed"])
    _set(lm.final_ln.weight, t["final_ln"])
    if lm.lm_head is not None:
        _linear(lm.lm_head, t["lm_head"])
    tl = t["layers"]
    for i, layer in enumerate(lm.layers):
        _set(layer.input_ln.weight, np.asarray(tl["input_ln"])[i])
        _set(layer.post_ln.weight, np.asarray(tl["post_ln"])[i])
        for attr, (wk, bk) in _TEXT_LAYER.items():
            _linear(
                getattr(layer, attr),
                np.asarray(tl[wk])[i],
                None if bk is None else np.asarray(tl[bk])[i],
            )

    v, tower = params["vision"], m.vision
    _linear(tower.patch_embed, v["patch_embed"])
    vb = v["blocks"]
    for i, blk in enumerate(tower.blocks):
        _set(blk.norm1.weight, np.asarray(vb["norm1"])[i])
        _set(blk.norm2.weight, np.asarray(vb["norm2"])[i])
        for attr, (wk, bk) in _VISION_BLOCK.items():
            _linear(getattr(blk, attr), np.asarray(vb[wk])[i], np.asarray(vb[bk])[i])
    mp = v["merger"]
    _set(tower.ln_q.weight, mp["ln_q"])
    _linear(tower.merger_fc1, mp["fc1_w"], mp["fc1_b"])
    _linear(tower.merger_fc2, mp["fc2_w"], mp["fc2_b"])
    return m.eval().requires_grad_(False)
