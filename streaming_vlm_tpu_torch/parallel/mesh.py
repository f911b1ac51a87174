"""Mesh construction and the sharding rules: which dim of which weight, KV
arena and optimizer moment splits over which mesh axis.

Port of streaming_vlm_tpu/parallel/mesh.py. The rule tables, the
`/(q|s)$` suffix strip and the divisibility fallback are the JAX package's,
copied verbatim (tests/test_torch_imports.py holds them equal), and
`sharding_for_tree` returns, for a tree in the JAX layout (stacked layers,
[in, out] matrices), the same spec per leaf as JAX's `sharding_for_tree`.
A spec is a tuple of axis names (or None) per dim, `P(...)`.

`placement` maps the rules onto the port's modules (nn.Linear's [out, in],
one module per layer) and is what `parallel/tp.py` shards by. It equals the
rules leaf for leaf, except where a split would cut a head or a fused block
(GSPMD re-shards before the attention; an explicit port cannot), listed in
here and held by tests/test_torch_parallel_mesh.py:

* vision `blocks/qkv_w` / `qkv_b`: the rules split the [D, 3 H hd] columns
  contiguously, which gives one rank all of q and half of k; the port splits
  q, k and v each by heads (the same dim, the same share of columns);
* a text or vision attention projection whose head count the `model` axis
  does not divide (the tiny config's `k_w`, 2 heads of 16, at model=4, which
  JAX splits mid-head) is replicated, and the tensor-parallel forward then
  refuses the mesh (ValueError);
* W4A8 `{"q4", "s"}` leaves: the strip `/(q|s)$` misses "q4", so JAX
  replicates the packed weight while splitting its scales; the port splits
  q4 as its scales, and a split that would cut a 128-row scale group raises
  ValueError.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .distributed import Mesh


class P(tuple):
    """A partition spec: one mesh axis name (or None: not split) per dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def make_mesh(shape: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """The named-axis mesh over the world's ranks (`Mesh`); its size must be
    the world's. `devices` is taken for the JAX signature and must be None
    (each rank's device is its own)."""
    if devices is not None:
        raise ValueError("make_mesh: a rank owns one device; pass devices=None")
    return Mesh(shape)


def as_mesh(mesh) -> Optional[Mesh]:
    """A Mesh from a Mesh, an {axis: size} dict (`make_mesh`) or None."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return make_mesh(dict(mesh))


def _shape(mesh) -> Dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


# Text-model tensor-parallel + FSDP rules. Keys are regexes over the param
# tree path ("layers/q_w" etc.); values are PartitionSpecs. Layer-stacked
# leaves have a leading layer axis (None).
TEXT_TP_RULES: Tuple[Tuple[str, P], ...] = (
    # attention: shard heads (last dim of q/k/v, first matmul dim of o)
    (r"layers/q_w$", P(None, "data", "model")),
    (r"layers/q_b$", P(None, "model")),
    (r"layers/[kv]_w$", P(None, "data", "model")),
    (r"layers/[kv]_b$", P(None, "model")),
    (r"layers/o_w$", P(None, "model", "data")),
    # mlp: shard intermediate dim
    (r"layers/(gate|up)_w$", P(None, "data", "model")),
    (r"layers/down_w$", P(None, "model", "data")),
    (r"layers/(input|post)_ln$", P(None)),
    # embeddings / head: shard vocab
    (r"embed$", P("model", "data")),
    (r"lm_head$", P("data", "model")),
    (r"final_ln$", P()),
)

VISION_TP_RULES: Tuple[Tuple[str, P], ...] = (
    (r"blocks/qkv_w$", P(None, "data", "model")),
    (r"blocks/qkv_b$", P(None, "model")),
    (r"blocks/proj_w$", P(None, "model", "data")),
    (r"blocks/proj_b$", P(None)),
    (r"blocks/(gate|up)_w$", P(None, "data", "model")),
    (r"blocks/(gate|up)_b$", P(None, "model")),
    (r"blocks/down_w$", P(None, "model", "data")),
    (r"blocks/down_b$", P(None)),
    (r"blocks/norm[12]$", P(None)),
    (r"patch_embed$", P("data", "model")),
    (r"merger/fc1_w$", P(None, "model")),
    (r"merger/fc1_b$", P("model")),
    (r"merger/fc2_w$", P("model", None)),
    (r"merger/(fc2_b|ln_q)$", P()),
)


def spec_for(path: str, shape: Sequence[int], mesh, rules: Sequence[Tuple[str, P]]) -> P:
    """The spec of one leaf at "/"-joined `path` with `shape`: the first rule
    that matches the path (a trailing /q or /s stripped), its axes dropped
    where they do not divide the dim; no match: replicated, P()."""
    sizes = _shape(mesh)
    s = re.sub(r"/(q|s)$", "", path)
    ps = None
    for pat, spec in rules:
        if re.search(pat, s):
            ps = spec
            break
    if ps is None:
        return P()
    fixed = []
    for dim, axis in zip(shape, tuple(ps) + (None,) * (len(shape) - len(ps))):
        if axis is None:
            fixed.append(None)
        else:
            size = sizes[axis] if isinstance(axis, str) else int(np.prod([sizes[a] for a in axis]))
            fixed.append(axis if dim % size == 0 else None)
    return P(*fixed)


def sharding_for_tree(params: Any, mesh, rules: Sequence[Tuple[str, P]]) -> Any:
    """The spec tree of a JAX-layout tree (nested dicts whose leaves have a
    .shape): `spec_for` at every leaf."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        return spec_for("/".join(path), tuple(np.shape(node)), mesh, rules)

    return walk(params, [])


def serving_rules(rules: Sequence[Tuple[str, P]]) -> Tuple[Tuple[str, P], ...]:
    """TP-only variants of the rules for the serving mesh: the 'data' axis is
    reserved for lanes (DP over concurrent streams), so weights replicate
    over it (an FSDP-split weight would be gathered at every layer of every
    decode step)."""
    return tuple((pat, P(*[None if a == "data" else a for a in tuple(spec)]))
                 for pat, spec in rules)


def _lane_axis(mesh, lanes: Optional[int]) -> Optional[str]:
    d = int(_shape(mesh).get("data", 1))
    if lanes is not None and d > 1 and lanes % d == 0:
        return "data"
    return None


def arena_sharding(mesh, kv_heads: int, *, batched: bool = False,
                   lanes: Optional[int] = None) -> P:
    """The spec of the KV arena [L, C, Hkv, hd] (batched: [B, L, C, Hkv,
    hd]): kv heads over 'model' where it divides them, else replicated; with
    `lanes` the stacked arena's lane dim also over 'data' (B % data == 0)."""
    m = int(_shape(mesh).get("model", 1))
    kv_ax = "model" if (m > 1 and kv_heads % m == 0) else None
    lane_ax = _lane_axis(mesh, lanes) if batched else None
    spec = (lane_ax, None, None, kv_ax, None) if batched else (None, None, kv_ax, None)
    if all(a is None for a in spec):
        return P()
    return P(*spec)


def arena_sharding_tree(mesh, kv_heads: int, arena: Any, *, batched: bool = False,
                        lanes: Optional[int] = None) -> Any:
    """`arena_sharding` for either arena form: a plain tensor's spec, or for
    the int8 {"q", "s"} form (ops.quant.QuantKV) the scales' spec too, the
    same axes without head_dim."""
    sh = arena_sharding(mesh, kv_heads, batched=batched, lanes=lanes)
    if not isinstance(arena, dict) and not hasattr(arena, "_fields"):
        return sh
    nd_q = 5 if batched else 4
    spec = tuple(sh) + (None,) * (nd_q - len(sh))
    s_spec = P(*spec[:-1]) if any(a is not None for a in spec[:-1]) else P()
    return {"q": sh, "s": s_spec}


def arena_shard_factor(mesh, kv_heads: int, *, lanes: Optional[int] = None) -> int:
    """How many ways the arena's bytes split across ranks (1: replicated),
    for the per-card memory guards; with `lanes` also the lanes over 'data'."""
    if mesh is None:
        return 1
    sizes = _shape(mesh)
    m = int(sizes.get("model", 1))
    f = m if (m > 1 and kv_heads % m == 0) else 1
    lane_ax = _lane_axis(mesh, lanes)
    if lane_ax is not None:
        f *= int(sizes[lane_ax])
    return f


# ---------------------------------------------------------------------------
# The rules on the port's modules
# ---------------------------------------------------------------------------

# port submodule attr -> the JAX stacked-layer keys (weight, bias)
TEXT_LINEARS = {
    "q_proj": ("q_w", "q_b"), "k_proj": ("k_w", "k_b"), "v_proj": ("v_w", "v_b"),
    "o_proj": ("o_w", None), "gate_proj": ("gate_w", None), "up_proj": ("up_w", None),
    "down_proj": ("down_w", None),
}
VISION_LINEARS = {
    "qkv": ("qkv_w", "qkv_b"), "proj": ("proj_w", "proj_b"), "gate_proj": ("gate_w", "gate_b"),
    "up_proj": ("up_w", "up_b"), "down_proj": ("down_w", "down_b"), "fc1": ("fc1_w", "fc1_b"),
    "fc2": ("fc2_w", "fc2_b"),
}
ATTN_VISION = ("qkv", "proj")

class Linear(NamedTuple):
    """One linear of the port in the rules' terms."""

    name: str  # the module's path in the model
    module: Any
    w_path: str  # the JAX path of its weight
    b_path: Optional[str]  # of its bias
    heads: int  # an attention projection's head count, else 0


def linears(cfg, model) -> List[Linear]:
    """Every linear of a Qwen25VL model, in the rules' terms. `heads` is the
    head count of an attention projection (q: H, k/v: Hkv, o: H; vision: its
    heads), else 0."""
    out = []
    t = cfg.text
    heads = {"q_proj": t.num_attention_heads, "k_proj": t.num_key_value_heads,
             "v_proj": t.num_key_value_heads, "o_proj": t.num_attention_heads}
    for i, layer in enumerate(model.text.layers):
        for attr, (wk, bk) in TEXT_LINEARS.items():
            out.append(Linear(f"text.layers.{i}.{attr}", getattr(layer, attr),
                              f"text/layers/{wk}", bk and f"text/layers/{bk}", heads.get(attr, 0)))
    if model.text.lm_head is not None:
        out.append(Linear("text.lm_head", model.text.lm_head, "text/lm_head", None, 0))
    tower = model.vision
    vh = cfg.vision.num_heads
    for i, blk in enumerate(tower.blocks):
        for attr, (wk, bk) in VISION_LINEARS.items():
            if not hasattr(blk, attr):
                continue
            out.append(Linear(f"vision.blocks.{i}.{attr}", getattr(blk, attr), f"vision/blocks/{wk}",
                              f"vision/blocks/{bk}", vh if attr in ATTN_VISION else 0))
    out.append(Linear("vision.patch_embed", tower.patch_embed, "vision/patch_embed", None, 0))
    out.append(Linear("vision.merger_fc1", tower.merger_fc1, "vision/merger/fc1_w",
                      "vision/merger/fc1_b", 0))
    out.append(Linear("vision.merger_fc2", tower.merger_fc2, "vision/merger/fc2_w",
                      "vision/merger/fc2_b", 0))
    return out


def _in_out(mod) -> Tuple[int, int]:
    return int(mod.in_features), int(mod.out_features)


def _stacked(path: str) -> bool:
    return "/layers/" in path or "/blocks/" in path


def linear_spec(lin: Linear, mesh, rules) -> Tuple[P, Optional[P]]:
    """The rules' specs of one linear's weight, in the JAX [in, out] layout
    of one layer (the layer axis dropped), and of its bias ([out]), before
    the port's deviations. A quantized weight's spec is its "q" leaf's (the
    scales' follow the out dim)."""
    k, n = _in_out(lin.module)
    w_path, b_path, mod = lin.w_path, lin.b_path, lin.module
    lead = (1,) if _stacked(w_path) else ()
    w = spec_for(w_path, lead + (k, n), mesh, rules)[len(lead):]
    w = P(*(tuple(w) + (None,) * (2 - len(w))))
    b = None
    if b_path is not None and getattr(mod, "bias", None) is not None:
        b = spec_for(b_path, lead + (n,), mesh, rules)[len(lead):]
        b = P(*(tuple(b) + (None,) * (1 - len(b))))
    return w, b


def placement(cfg, model, mesh, *, serving: bool) -> Dict[str, Tuple[P, Optional[P]]]:
    """The port's placement: linear name -> (weight spec in the JAX [in, out]
    layout, bias spec), from the rules (`serving_rules` when serving) with
    the listed deviations: an attention projection whose heads 'model' does
    not divide is replicated on that axis. The embedding's spec is under
    "text.embed" ([V, D])."""
    present = _shape(mesh)
    sizes = {"data": 1, "model": 1, **present}  # an axis the mesh lacks: not split

    def on_mesh(spec):
        return None if spec is None else P(*[a if a in present else None for a in spec])

    text_rules = serving_rules(TEXT_TP_RULES) if serving else TEXT_TP_RULES
    vision_rules = serving_rules(VISION_TP_RULES) if serving else VISION_TP_RULES
    m = int(sizes.get("model", 1))
    out = {}
    for lin in linears(cfg, model):
        rules = text_rules if lin.w_path.startswith("text/") else vision_rules
        w, b = (on_mesh(x) for x in linear_spec(lin, sizes, rules))
        if lin.heads and lin.heads % m:
            w = P(*[None if a == "model" else a for a in w])
            b = None if b is None else P(*[None if a == "model" else a for a in b])
        out[lin.name] = (w, b)
    V, D = model.text.embed.weight.shape
    out["text.embed"] = (on_mesh(spec_for("text/embed", (V, D), sizes, text_rules)), None)
    return out


def shard_opt_state(state: Any, params: Sequence) -> Any:
    """The optimizer state over sharded parameters (JAX `shard_opt_state`):
    AdamW's mu / nu and MultiSteps' accumulator are made by
    `optimizer.init` at each local shard's size (`torch.zeros_like` of the
    shard), so no rank holds a replicated moment; this checks that each
    has its shard's shape, and returns the state."""
    for key in ("mu", "nu", "acc"):
        for node in _find(state, key):
            for m, p in zip(node, params):
                if tuple(m.shape) != tuple(p.shape):
                    raise ValueError(f"{key}: a moment of shape {tuple(m.shape)} for a shard "
                                     f"{tuple(p.shape)}")
    return state


def _find(state: Any, key: str):
    if isinstance(state, dict):
        for k, v in state.items():
            if k == key and isinstance(v, list):
                yield v
            else:
                yield from _find(v, key)
