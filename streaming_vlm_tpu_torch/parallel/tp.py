"""Tensor parallelism over the mesh's 'model' axis (and, for training, FSDP
over 'data'), as explicit shards and collectives.

`shard_params_serving(cfg, model, mesh)` (serving) and `shard_params` (training)
cut a full model in place by
`parallel.mesh.placement` and returns the rank-local config (the text heads
divided by the 'model' size; everything else as it was). The decoder code
(models/qwen25_vl/language.py, vision.py) then runs unchanged on each rank's
shard, through the modules below:

* q/k/v and gate/up are column-parallel: each rank holds its heads' (its
  intermediate columns') rows of the weight, and the input enters through
  `copy_to` (the identity forward, the gradient summed over the group);
* o and down are row-parallel: each rank's product over its input columns,
  summed over the group by `reduce_from` (the sum forward, the identity
  backward), then the whole bias;
* the embedding is vocab-split: a masked lookup of the rank's rows, then a
  sum; `lm_head` is vocab-split, and `language.lm_logits` gathers the
  logits over the group (`LanguageModel.vocab_group`) before sampling, so
  every rank samples the same token from the same logits;
* each rank runs K1, K2 and K3 on its own H / tp query and Hkv / tp kv
  heads (G stays the same);
* the vision tower: qkv split by heads of each of q, k and v, proj and
  down row-parallel, gate / up and the merger's fc1 column-parallel, its
  fc2 row-parallel, the patch embedding column-parallel with its output
  gathered.

W8A8 (`ops.quant.QLinear`): a column-parallel product is the rank's rows of
the int8 weight through K5, bit for bit the columns of the unsharded one. A
row-parallel product (`RowParallelQLinear`) quantizes its rows over the
whole contracted dim, as GSPMD does: each row's absmax is a MAX all-reduce
of the ranks' absmax, the int8 rows of its columns go through K5's int32
form (`ops.quant.int8_gemm`), the int32 partials are summed over the group
(exact), then rescaled; so every W8A8 product under TP equals the unsharded
`qdot` bit for bit. W4A8 (`QLinear4`): column-parallel the same way; a
row-parallel product runs each rank's scale groups through qdot4 to f32 and
sums them (qdot4 folds the groups in order, which a split cannot keep: the
sum is within f32 roundoff, not bitwise), and a split that would cut a
128-row scale group raises ValueError.

Training (`serving=False`): a weight's 'data'-split dim is gathered for the
product (`gather`: all-gather forward, reduce-scatter backward: FSDP), and
`head_weight` gathers the whole [V, D] head for the fused CE, whose
gradient each rank takes back for its own rows (`gather_take`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import INV127, QLinear, QLinear4, int8_gemm, padded_k, qdot4
from . import distributed as D
from .mesh import linears, placement


# ---------------------------------------------------------------------------
# Collectives with their transposes (autograd Functions)
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """The identity; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the group; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return D.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim`; the gradient reduce-scattered (FSDP)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return D.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return D.reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


class _GatherTake(torch.autograd.Function):
    """All-gather along `dim`; the gradient's own part taken back (what
    follows runs replicated, each rank computing the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.i = torch.distributed.get_rank(group) if group is not None else 0
        return D.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n).contiguous(), None, None


class _Take(torch.autograd.Function):
    """This rank's equal part along `dim` of a replicated tensor; the
    gradient all-gathered (the replicated input's gradient, the same on
    every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = torch.distributed.get_world_size(group) if group is not None else 1
        i = torch.distributed.get_rank(group) if group is not None else 0
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return D.all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, group, dim)


def gather_take(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherTake.apply(x, group, dim)


def take(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _Take.apply(x, group, dim)


# ---------------------------------------------------------------------------
# Sharded modules
# ---------------------------------------------------------------------------


class ParallelLinear(nn.Module):
    """A float linear's shard. kind "col": the rank's rows of the [out, in]
    weight (and of the bias); "row": its columns (the whole bias, added
    after the sum); "rep": the whole weight. `fsdp` = (dim, group): the
    weight's dim `dim` is also split over the data axis and gathered for the
    product."""

    def __init__(self, weight, bias, kind: str, group, fsdp=None):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone(), requires_grad=weight.requires_grad)
        self.bias = (None if bias is None else
                     nn.Parameter(bias.detach().clone(), requires_grad=bias.requires_grad))
        self.kind, self.group, self.fsdp = kind, group, fsdp

    def tp_weight(self) -> torch.Tensor:
        """The rank's tensor-parallel weight (gathered over the data axis)."""
        return self.weight if self.fsdp is None else gather(self.weight, self.fsdp[1], self.fsdp[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.tp_weight()
        if self.kind == "row":
            y = reduce_from(F.linear(x, w), self.group)
            return y if self.bias is None else y + self.bias
        if self.kind == "col":
            x = copy_to(x, self.group)
        return F.linear(x, w, self.bias)

    def full_weight(self) -> torch.Tensor:
        """The whole [out, in] weight on every rank (the CE head), its
        gradient taken back by each rank for its own part."""
        w = self.tp_weight()
        return gather_take(w, self.group, 0) if self.kind == "col" else w


class RowParallelQLinear(nn.Module):
    """A W8A8 row-parallel product (see the module docstring): `inner` holds
    the rank's contract columns of the int8 weight, all the scales and the
    bias."""

    def __init__(self, inner: QLinear, group):
        super().__init__()
        self.inner, self.group = inner, group

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        lead, K = x.shape[:-1], x.shape[-1]
        xf = x.reshape(-1, K).float()
        amax = D.all_reduce(xf.abs().amax(dim=-1, keepdim=True), self.group, "max")
        sx = (amax * INV127).clamp_min(1e-12)  # ops.quant._absmax_scale over the whole row
        # K5 takes K % 4 == 0 in rows 16-byte multiples apart: the rank's
        # columns (vision down_proj: 3420 / 2 = 1710) padded with zero
        # columns in both operands (QLinear's rows are zero-padded), which add
        # nothing to the int32 sums
        k4 = -(-K // 4) * 4
        xq = torch.zeros(xf.shape[0], padded_k(K), dtype=torch.int8, device=x.device)
        xq[:, :K] = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        acc = int8_gemm(xq[:, :k4], self.inner.q_rows[:, :k4])  # K5, int32 partials
        acc = D.all_reduce(acc, self.group)
        out = (acc.float() * (sx * self.inner.s)).to(out_dtype or x.dtype).reshape(*lead, -1)
        return out if self.inner.bias is None else out + self.inner.bias


class RowParallelQLinear4(nn.Module):
    """A W4A8 row-parallel product: the rank's scale groups through qdot4 to
    f32, summed over the group, then cast and + bias."""

    def __init__(self, inner: QLinear4, group, bias):
        super().__init__()
        self.inner, self.group, self.bias = inner, group, bias

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        part = qdot4(x, self.inner.q4, self.inner.s, None, torch.float32)
        out = D.all_reduce(part, self.group).to(out_dtype or x.dtype)
        return out if self.bias is None else out + self.bias


class GatherColumns(nn.Module):
    """A column-parallel linear whose output is gathered (the patch
    embedding, whose output feeds replicated norms)."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner, self.group = inner, group

    @property
    def weight(self):
        return self.inner.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return D.all_gather(self.inner(x), self.group, x.dim() - 1)


class VocabParallelEmbedding(nn.Module):
    """The embedding's rows [v0, v0 + V / tp) on this rank: a masked lookup,
    summed over the group (exact: one rank holds each id's row, the others
    add zeros). `fsdp`: (1, group) when the hidden dim is also split over
    the data axis."""

    def __init__(self, weight, v0: int, group, fsdp=None):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone(), requires_grad=weight.requires_grad)
        self.v0, self.group, self.fsdp = int(v0), group, fsdp

    def tp_weight(self) -> torch.Tensor:
        return self.weight if self.fsdp is None else gather(self.weight, self.fsdp[1], self.fsdp[0])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        w = self.tp_weight()
        local = ids - self.v0
        ok = (local >= 0) & (local < w.shape[0])
        emb = F.embedding(local.clamp(0, w.shape[0] - 1), w)
        emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
        return reduce_from(emb, self.group)

    def full_weight(self) -> torch.Tensor:
        return gather_take(self.tp_weight(), self.group, 0)


# ---------------------------------------------------------------------------
# Sharding a model
# ---------------------------------------------------------------------------


def _chunk(t: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    """Part i of n along dim, in storage of its own (a view's offset would
    break the kernels' 16-byte alignment)."""
    return t.chunk(n, dim=dim)[i].clone(memory_format=torch.contiguous_format)


def _head_rows(t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rank i's rows of a fused [3 * H * hd, ...] qkv weight (or bias): its
    heads of each of q, k and v."""
    parts = t.reshape(3, -1, *t.shape[1:])
    return _chunk(parts, n, i, 1).reshape(-1, *t.shape[1:])


def _axis_dim(spec, axis: str) -> Optional[int]:
    """The port's [out, in] dim that `axis` splits in a JAX-layout [in, out]
    weight spec (0: out, 1: in), or None."""
    if len(spec) > 1 and spec[1] == axis:
        return 0
    if len(spec) > 0 and spec[0] == axis:
        return 1
    return None


def local_config(cfg, tp: int):
    """The rank-local config: the text model's H / tp and Hkv / tp heads.
    The vision tower keeps its config (its code reads the local head count
    from the qkv output)."""
    t = cfg.text
    return dataclasses.replace(cfg, text=dataclasses.replace(
        t, num_attention_heads=t.num_attention_heads // tp,
        num_key_value_heads=t.num_key_value_heads // tp))


def check_heads(cfg, tp: int) -> None:
    """ValueError unless the 'model' axis divides the text model's query and
    kv heads and the vision tower's heads."""
    t, v = cfg.text, cfg.vision
    for what, n in (("query heads", t.num_attention_heads), ("kv heads", t.num_key_value_heads),
                    ("vision heads", v.num_heads)):
        if n % tp:
            raise ValueError(f"the mesh's 'model' axis ({tp}) does not divide the {n} {what} "
                             f"of {cfg.name}: each rank must own whole heads")


def _shard_linear(mod, w_spec, b_spec, kind_hint: str, tp: int, r: int, group, fsdp):
    """The rank's module for one linear (see _shard_model)."""
    mdim = _axis_dim(w_spec, "model")
    kind = "rep" if mdim is None else ("col" if mdim == 0 else "row")
    rows = (lambda t: _head_rows(t, tp, r)) if kind_hint == "qkv" else (
        lambda t: _chunk(t, tp, r, 0))
    if isinstance(mod, QLinear):
        if fsdp is not None:
            raise ValueError("FSDP over 'data' takes float weights, not W8A8")
        if kind == "rep":
            return mod
        if kind == "col":
            new = QLinear(mod.in_features, mod.out_features // tp, mod.bias is not None,
                          device=mod.s.device, dtype=mod.bias.dtype if mod.bias is not None
                          else torch.float32)
            new.q, new.s = rows(mod.q), rows(mod.s)
            if mod.bias is not None:
                new.bias.data.copy_(rows(mod.bias))
            return new
        k = mod.in_features // tp
        inner = QLinear(k, mod.out_features, mod.bias is not None, device=mod.s.device,
                        dtype=mod.bias.dtype if mod.bias is not None else torch.float32)
        inner.q, inner.s = _chunk(mod.q, tp, r, 1), mod.s.clone()
        if mod.bias is not None:
            inner.bias.data.copy_(mod.bias)
        return RowParallelQLinear(inner, group)
    if isinstance(mod, QLinear4):
        if fsdp is not None:
            raise ValueError("FSDP over 'data' takes float weights, not W4A8")
        if kind == "rep":
            return mod
        if kind == "col":
            new = QLinear4(mod.in_features, mod.out_features // tp, mod.bias is not None,
                           device=mod.s.device)
            new.q4, new.s = rows(mod.q4), rows(mod.s)
            if mod.bias is not None:
                new.bias = nn.Parameter(rows(mod.bias), requires_grad=False)
            return new
        k = mod.in_features // tp
        if mod.ng == 1 or mod.ng % tp:
            raise ValueError(
                f"W4A8 row-parallel split of in_features {mod.in_features} over 'model' = {tp}: "
                f"its {mod.ng} scale group(s) of 128 rows would straddle the split")
        inner = QLinear4(k, mod.out_features, False, device=mod.s.device)
        inner.q4, inner.s = _chunk(mod.q4, tp, r, 1), _chunk(mod.s, tp, r, 1)
        return RowParallelQLinear4(inner, group, mod.bias)
    w, b = mod.weight, mod.bias
    if kind == "col":
        w, b = rows(w), None if b is None else rows(b)
    elif kind == "row":
        w = _chunk(w, tp, r, 1)
    if fsdp is not None:
        w = _chunk(w, torch.distributed.get_world_size(fsdp[1]), fsdp[2], fsdp[0])
        fsdp = fsdp[:2]
    return ParallelLinear(w, b, kind, group, fsdp)


def _shard_model(cfg, model, mesh, *, serving: bool):
    """Cut `model` (a full Qwen25VL, every rank the same weights) in place to
    this rank's shards by `parallel.mesh.placement`, and return the
    rank-local config (`local_config`). serving=True: tensor parallelism
    over 'model' only (weights replicated over 'data', which the serving
    engines keep for lanes). serving=False: the training rules, which also
    split the text model's weights over 'data' (FSDP: gathered per layer);
    the frozen vision tower takes the serving placement. A model already
    sharded on this mesh is returned as it is. ValueError where the 'model'
    axis does not divide the heads."""
    done = getattr(model, "_tp_shard", None)
    if done is not None:
        if done[0] is not mesh or done[1] != serving:
            raise ValueError("the model is already sharded on another mesh or mode")
        return done[2]
    tp = mesh.size("model") if "model" in mesh else 1
    check_heads(cfg, tp)
    group = mesh.group("model") if "model" in mesh else None
    r = mesh.index("model") if "model" in mesh else 0
    fsdp_on = not serving and "data" in mesh
    dgroup = mesh.group("data") if fsdp_on else None
    dr = mesh.index("data") if fsdp_on else 0
    text_place = placement(cfg, model, mesh, serving=serving)
    vis_place = text_place if serving else placement(cfg, model, mesh, serving=True)
    with torch.no_grad():
        for lin in linears(cfg, model):
            name, mod = lin.name, lin.module
            is_text = name.startswith("text.")
            w_spec, b_spec = (text_place if is_text else vis_place)[name]
            fsdp = None
            if is_text and fsdp_on:
                ddim = _axis_dim(w_spec, "data")
                fsdp = None if ddim is None else (ddim, dgroup, dr)
            hint = "qkv" if name.endswith(".qkv") else ""
            new = _shard_linear(mod, w_spec, b_spec, hint, tp, r, group, fsdp)
            if name == "vision.patch_embed" and _axis_dim(w_spec, "model") == 0:
                new = GatherColumns(new, group)
            parent, attr = name.rsplit(".", 1)
            setattr(model.get_submodule(parent), attr, new)
        lm = model.text
        e_spec = text_place["text.embed"][0]
        V = lm.embed.weight.shape[0]
        w = lm.embed.weight
        split_v = len(e_spec) > 0 and e_spec[0] == "model"
        if split_v:
            w = _chunk(w, tp, r, 0)
        e_fsdp = None
        if fsdp_on and len(e_spec) > 1 and e_spec[1] == "data":
            w = _chunk(w, mesh.size("data"), dr, 1)
            e_fsdp = (1, dgroup)
        lm.embed = VocabParallelEmbedding(w, r * (V // tp) if split_v else 0,
                                          group if split_v else None, e_fsdp)
        head_split = (lm.lm_head is None and split_v) or (
            lm.lm_head is not None and _axis_dim(text_place["text.lm_head"][0], "model") == 0)
        lm.vocab_group = group if head_split else None
    local = local_config(cfg, tp)
    model._tp_shard = (mesh, serving, local)
    return local


def shard_params(cfg, model, mesh):
    """JAX `shard_params` on the port's model: the training placement (FSDP
    over 'data' x TP over 'model'), in place; returns the rank-local
    config."""
    return _shard_model(cfg, model, mesh, serving=False)


def shard_params_serving(cfg, model, mesh):
    """JAX `shard_params_serving`: tensor parallelism over 'model', weights
    replicated over 'data' (the lanes' axis), in place; returns the
    rank-local config."""
    return _shard_model(cfg, model, mesh, serving=True)


def sharded_params(model):
    """(parameter, axes it is split over) for every trainable text
    parameter of a model cut by `shard_params`, in
    `model.text.parameters()` order: what the sharded gradient norm and the
    data-axis gradient sum need."""
    mesh, _, _ = model._tp_shard
    out = {}
    for mod in model.text.modules():
        axes = set()
        if isinstance(mod, (ParallelLinear, VocabParallelEmbedding)):
            if mod.fsdp is not None:
                axes.add("data")
            if isinstance(mod, VocabParallelEmbedding):
                if mod.group is not None:
                    axes.add("model")
            elif mod.kind in ("col", "row") and mod.group is not None:
                axes.add("model")
            out[id(mod.weight)] = tuple(a for a in mesh.axis_names if a in axes)
            if getattr(mod, "bias", None) is not None:
                b_axes = {"model"} if isinstance(mod, ParallelLinear) and mod.kind == "col" \
                    and mod.group is not None else set()
                out[id(mod.bias)] = tuple(a for a in mesh.axis_names if a in b_axes)
    return [(p, out.get(id(p), ())) for p in model.text.parameters()]
