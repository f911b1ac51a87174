"""Weight bridge: the JAX package's parameter pytree -> the port's modules.

The only code that knows the JAX layout (models/qwen25_vl/language.py and
vision.py `init_*_params`): decoder and vision-block weights are stacked
along a leading [L, ...] axis and matrices are stored [in, out]. Here the
layer axis is unstacked and matrices are transposed into nn.Linear's
[out, in]. Input leaves are numpy arrays (np.asarray of the JAX arrays), so
this module never imports jax. W8A8 trees (the JAX package's
`quantize_model_params`) hold {"q" int8 [L, in, out], "s" f32 [L, 1, out]}
leaves; they become `ops.quant.QLinear` modules with q [out, in], s [out].
W4A8 trees (`quantize_model_params(text_bits=4)`) hold {"q4" int8 [L, in/2,
out] (two contract rows a byte), "s" f32 [L, ng, out]} leaves; they become
`ops.quant.QLinear4` modules with q4 [out, in/2] (the same bytes, so the
same nibble order) and s [out, ng]. `to_jax_params` is the inverse for a
float model (or its gradients): the JAX tree as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops.quant import QLinear, QLinear4, is_qtensor
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
    form, for a QLinear: q -> [out, in], s -> [out]; or its {"q4" [in/2,
    out], "s" [ng, out]} int4 form, for a QLinear4: q4 -> [out, in/2], s ->
    [out, ng]) and bias."""
    if isinstance(lin, QLinear):
        lin.q.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(w["q"]).T)))
        _set(lin.s, np.asarray(w["s"]).reshape(-1))
    elif isinstance(lin, QLinear4):
        q4 = np.asarray(w["q4"]).T
        if q4.shape != tuple(lin.q4.shape):
            raise ValueError(f"shape mismatch: JAX q4 {q4.shape[::-1]} vs port "
                             f"{tuple(lin.q4.shape)}")
        lin.q4.copy_(torch.from_numpy(np.ascontiguousarray(q4, np.int8)))
        _set(lin.s, np.asarray(w["s"]).T)
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
    """An empty QLinear (QLinear4 for an int4 leaf) in lin's place where
    the JAX leaf is quantized."""
    if not is_qtensor(leaf):
        return lin
    cls = QLinear4 if "q4" in leaf else QLinear
    return cls(lin.in_features, lin.out_features, lin.bias is not None, dtype=lin.weight.dtype)


@torch.no_grad()
def from_jax_params(
    cfg: ModelConfig, params: Dict[str, Any], *, device="cuda", dtype=torch.float32
) -> Qwen25VL:
    """Build the port's model from a JAX `model.init_params` pytree, or the
    W8A8 or W4A8 tree `quantize_model_params` makes of one (leaves as
    numpy arrays or anything np.asarray accepts), on the card unless the
    caller passes device="cpu". Either vision variant (qwen2: the LayerNorm biases
    norm1_b, norm2_b and the merger's ln_q_b, and fc1/fc2 in place of the
    SwiGLU). A {"q", "s"} leaf becomes a QLinear and a {"q4", "s"} leaf a
    QLinear4, bit for bit; a tied
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
            cls = QLinear4 if "q4" in head else QLinear
            lm.lm_head = cls(cfg.text.hidden_size, cfg.text.vocab_size, bias=False, dtype=dtype)
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


@torch.no_grad()
def to_jax_params(cfg: ModelConfig, model: Qwen25VL, *, grads: bool = False) -> Dict[str, Any]:
    """The inverse of `from_jax_params` for a float model: the JAX package's
    parameter pytree as numpy f32 arrays, layers stacked along [L, ...] and
    matrices transposed back to [in, out]. With grads=True each leaf is the
    parameter's `.grad` (zeros where it has none), so tests compare the
    port's gradients with jax.grad's leaf by leaf."""

    def arr(p: torch.Tensor) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().to("cpu", torch.float32).numpy()

    def stack(mods, get) -> np.ndarray:
        return np.stack([get(m) for m in mods])

    lm, tower = model.text, model.vision
    layers = {
        "input_ln": stack(lm.layers, lambda l: arr(l.input_ln.weight)),
        "post_ln": stack(lm.layers, lambda l: arr(l.post_ln.weight)),
    }
    for attr, (wk, bk) in _TEXT_LAYER.items():
        layers[wk] = stack(lm.layers, lambda l: arr(getattr(l, attr).weight).T)
        if bk is not None:
            layers[bk] = stack(lm.layers, lambda l: arr(getattr(l, attr).bias))
    text = {"embed": arr(lm.embed.weight), "layers": layers, "final_ln": arr(lm.final_ln.weight)}
    if lm.lm_head is not None:
        text["lm_head"] = arr(lm.lm_head.weight).T
    blocks = {
        "norm1": stack(tower.blocks, lambda b: arr(b.norm1.weight)),
        "norm2": stack(tower.blocks, lambda b: arr(b.norm2.weight)),
    }
    if getattr(tower.blocks[0].norm1, "bias", None) is not None:  # qwen2's LayerNorms
        blocks["norm1_b"] = stack(tower.blocks, lambda b: arr(b.norm1.bias))
        blocks["norm2_b"] = stack(tower.blocks, lambda b: arr(b.norm2.bias))
    for attr, (wk, bk) in _block_linears(tower.blocks[0]):
        blocks[wk] = stack(tower.blocks, lambda b: arr(getattr(b, attr).weight).T)
        blocks[bk] = stack(tower.blocks, lambda b: arr(getattr(b, attr).bias))
    merger = {"ln_q": arr(tower.ln_q.weight),
              "fc1_w": arr(tower.merger_fc1.weight).T, "fc1_b": arr(tower.merger_fc1.bias),
              "fc2_w": arr(tower.merger_fc2.weight).T, "fc2_b": arr(tower.merger_fc2.bias)}
    if getattr(tower.ln_q, "bias", None) is not None:
        merger["ln_q_b"] = arr(tower.ln_q.bias)
    vision = {"patch_embed": arr(tower.patch_embed.weight).T, "blocks": blocks, "merger": merger}
    return {"text": text, "vision": vision}
