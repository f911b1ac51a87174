"""Weight bridge: the JAX package's parameter pytree -> the port's modules.

The only code that knows the JAX layout (models/qwen25_vl/language.py and
vision.py `init_*_params`): decoder and vision-block weights are stacked
along a leading [L, ...] axis and matrices are stored [in, out]. Here the
layer axis is unstacked and matrices are transposed into nn.Linear's
[out, in]. Input leaves are numpy arrays (np.asarray of the JAX arrays), so
this module never imports jax. W8A8 trees (the JAX package's
`quantize_model_params`) hold {"q" int8 [L, in, out], "s" f32 [L, 1, out]}
leaves; they become `ops.quant.QLinear` modules with q [out, in], s [out].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops.quant import QLinear, is_qtensor
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
_VISION_BLOCK = {  # both variants; a block holds the ones of its variant
    "qkv": ("qkv_w", "qkv_b"),
    "proj": ("proj_w", "proj_b"),
    "gate_proj": ("gate_w", "gate_b"),  # qwen2_5
    "up_proj": ("up_w", "up_b"),
    "down_proj": ("down_w", "down_b"),
    "fc1": ("fc1_w", "fc1_b"),  # qwen2
    "fc2": ("fc2_w", "fc2_b"),
}


def _block_linears(blk: nn.Module):
    return [(attr, keys) for attr, keys in _VISION_BLOCK.items() if hasattr(blk, attr)]


def _set(p: torch.Tensor, arr: np.ndarray) -> None:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"shape mismatch: JAX {a.shape} vs port {tuple(p.shape)}")
    p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def _linear(lin: nn.Module, w, b=None) -> None:
    """A JAX [in, out] weight (or its {"q" [in, out], "s" [1, out]} int8
    form, for a QLinear: q -> [out, in], s -> [out]) and bias."""
    if isinstance(lin, QLinear):
        lin.q.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(w["q"]).T)))
        _set(lin.s, np.asarray(w["s"]).reshape(-1))
    else:
        _set(lin.weight, np.asarray(w).T)
    if b is not None:
        _set(lin.bias, b)


def _layer(leaf, i: int):
    """Layer i of a stacked [L, ...] leaf, or of each array of a {"q", "s"}
    leaf."""
    if is_qtensor(leaf):
        return {k: np.asarray(v)[i] for k, v in leaf.items()}
    return np.asarray(leaf)[i]


def _like(leaf, lin: nn.Linear) -> nn.Module:
    """An empty QLinear in lin's place where the JAX leaf is quantized."""
    if not is_qtensor(leaf):
        return lin
    if "q4" in leaf:
        raise NotImplementedError("int4 weights (W4A8) are not ported")
    return QLinear(lin.in_features, lin.out_features, lin.bias is not None,
                   dtype=lin.weight.dtype)


@torch.no_grad()
def from_jax_params(
    cfg: ModelConfig, params: Dict[str, Any], *, device="cuda", dtype=torch.float32
) -> Qwen25VL:
    """Build the port's model from a JAX `model.init_params` pytree, or the
    W8A8 tree `quantize_model_params` makes of one (leaves as numpy arrays
    or anything np.asarray accepts), on the card unless the caller passes
    device="cpu". Either vision variant (qwen2: the LayerNorm biases
    norm1_b, norm2_b and the merger's ln_q_b, and fc1/fc2 in place of the
    SwiGLU). A {"q", "s"} leaf becomes a QLinear, bit for bit; a tied
    model's "lm_head_q" becomes its lm_head."""
    t, v = params["text"], params["vision"]
    tl, vb = t["layers"], v["blocks"]
    with torch.device("meta"):
        m = Qwen25VL(cfg, dtype=dtype)
        lm, tower = m.text, m.vision
        for layer in lm.layers:
            for attr, (wk, _) in _TEXT_LAYER.items():
                setattr(layer, attr, _like(tl[wk], getattr(layer, attr)))
        head = t.get("lm_head_q", t.get("lm_head"))
        if head is not None and is_qtensor(head):
            lm.lm_head = QLinear(cfg.text.hidden_size, cfg.text.vocab_size, bias=False,
                                 dtype=dtype)
        for blk in tower.blocks:
            for attr, (wk, _) in _block_linears(blk):
                setattr(blk, attr, _like(vb[wk], getattr(blk, attr)))
        for attr, wk in (("merger_fc1", "fc1_w"), ("merger_fc2", "fc2_w")):
            setattr(tower, attr, _like(v["merger"][wk], getattr(tower, attr)))
    m.to_empty(device=device)

    _set(lm.embed.weight, t["embed"])
    _set(lm.final_ln.weight, t["final_ln"])
    if lm.lm_head is not None:
        _linear(lm.lm_head, head)
    for i, layer in enumerate(lm.layers):
        _set(layer.input_ln.weight, np.asarray(tl["input_ln"])[i])
        _set(layer.post_ln.weight, np.asarray(tl["post_ln"])[i])
        for attr, (wk, bk) in _TEXT_LAYER.items():
            _linear(getattr(layer, attr), _layer(tl[wk], i),
                    None if bk is None else np.asarray(tl[bk])[i])

    _linear(tower.patch_embed, v["patch_embed"])
    for i, blk in enumerate(tower.blocks):
        _set(blk.norm1.weight, np.asarray(vb["norm1"])[i])
        _set(blk.norm2.weight, np.asarray(vb["norm2"])[i])
        if "norm1_b" in vb:  # qwen2's LayerNorms
            _set(blk.norm1.bias, np.asarray(vb["norm1_b"])[i])
            _set(blk.norm2.bias, np.asarray(vb["norm2_b"])[i])
        for attr, (wk, bk) in _block_linears(blk):
            _linear(getattr(blk, attr), _layer(vb[wk], i), np.asarray(vb[bk])[i])
    mp = v["merger"]
    _set(tower.ln_q.weight, mp["ln_q"])
    if "ln_q_b" in mp:
        _set(tower.ln_q.bias, mp["ln_q_b"])
    _linear(tower.merger_fc1, mp["fc1_w"], mp["fc1_b"])
    _linear(tower.merger_fc2, mp["fc2_w"], mp["fc2_b"])
    return m.eval().requires_grad_(False)
