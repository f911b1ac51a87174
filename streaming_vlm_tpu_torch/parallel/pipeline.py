"""Pipeline parallelism (GPipe) over the decoder layers, on a 'stage' mesh
axis.

Port of streaming_vlm_tpu/parallel/pipeline.py. Stage s holds only layers
[s L / S, (s + 1) L / S) (`split_stages` cuts the model's layer list in
place). Plain GPipe fill and drain over M microbatches: M + S - 1 steps;
at step t stage s runs microbatch t - s, receiving its [T, D] carry from
stage s - 1 and sending it on to s + 1 (`distributed.send` / `recv`). The
backward runs each stage's microbatches in reverse: it receives the
output's gradient from stage s + 1, differentiates its saved graph, and
sends the input's gradient to stage s - 1. `pipeline_language_forward` is
one torch.autograd.Function over the stage's parameters, so its gradients
are those of the one-card stack, each layer's on the rank that holds it.

The embedding, vision scatter, final norm and CE head sit outside the
pipeline, replicated on every rank, as in JAX; the last stage's outputs
are broadcast over the stage line (JAX's psum), and stage 0's input
gradient back over it, so the replicated parameters end every step with
the same gradient, and so the same values, on every rank. A 'data' axis
splits the microbatches into independent pipelines whose layer gradients
are summed over it. In-stage remat ("full" / "dots") checkpoints each layer,
as JAX `_stage_scan`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..models.qwen25_vl import language
from ..models.qwen25_vl.rope import make_inv_freq, mrope_cos_sin
from ..ops.attention import train_attention
from . import distributed as D
from .tp import gather_take, take


def split_stages(cfg, model, mesh, stage_axis: str = "stage") -> range:
    """Keep this rank's layers of `model.text` (in place) and return their
    indices in the whole stack. ValueError unless the stages divide the
    layers."""
    done = getattr(model, "_pp_stage", None)
    if done is not None:
        return done
    L, S = cfg.text.num_hidden_layers, mesh.size(stage_axis)
    if L % S:
        raise ValueError(f"layers {L} must divide stages {S}")
    s = mesh.index(stage_axis)
    keep = range(s * L // S, (s + 1) * L // S)
    model.text.layers = nn.ModuleList(model.text.layers[i] for i in keep)
    model._pp_stage = keep
    return keep


def _stage(cfg, layers, hidden, cos, sin, remat: str):
    """One stage's layers over one microbatch's carry [T, D] (the training
    stack's layer: K1 / K1-bwd causal attention)."""

    def layer_fn(h, layer):
        q, _, k_rot, v = language._qkv(cfg, h, layer, cos, sin)
        return language._layer_tail(layer, h, train_attention(q, k_rot, v))

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts, language._dots_saveable)
    for layer in layers:
        if remat == "none":
            hidden = layer_fn(hidden, layer)
        else:
            hidden = torch.utils.checkpoint.checkpoint(layer_fn, hidden, layer,
                                                       use_reentrant=False, **kw)
    return hidden


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_mb, cos_mb, sin_mb, run, *params):
        cfg, layers, remat, ranks, group, dgroup = run
        S, s = len(ranks), ranks.index(torch.distributed.get_rank()) if group is not None else 0
        M = x_mb.shape[0]
        saved: List[Tuple[torch.Tensor, torch.Tensor]] = [None] * M
        out = torch.zeros_like(x_mb)
        with torch.enable_grad():
            for t in range(M + S - 1):  # GPipe: stage s holds microbatch t - s
                m = t - s
                if not 0 <= m < M:
                    continue
                inp = x_mb[m] if s == 0 else D.recv(x_mb[m], ranks[s - 1], group)
                inp = inp.detach().requires_grad_()
                y = _stage(cfg, layers, inp, cos_mb[m], sin_mb[m], remat)
                saved[m] = (inp, y)
                if s < S - 1:
                    D.send(y, ranks[s + 1], group)
                else:
                    out[m] = y.detach()
        ctx.saved, ctx.run, ctx.params = saved, run, params
        # the collected outputs live on the last stage: on every rank (psum)
        return D.broadcast(out, ranks[-1], group) if group is not None else out

    @staticmethod
    def backward(ctx, grad):
        cfg, layers, remat, ranks, group, dgroup = ctx.run
        S, s = len(ranks), ranks.index(torch.distributed.get_rank()) if group is not None else 0
        params = [p for p in ctx.params]
        M = grad.shape[0]
        dx = torch.zeros_like(grad)
        p_grads = [torch.zeros_like(p) for p in params]
        for m in reversed(range(M)):
            inp, y = ctx.saved[m]
            g = grad[m] if s == S - 1 else D.recv(grad[m], ranks[s + 1], group)
            got = torch.autograd.grad(y, [inp] + params, g, allow_unused=True)
            for acc, gp in zip(p_grads, got[1:]):
                if gp is not None:
                    acc += gp
            if s > 0:
                D.send(got[0], ranks[s - 1], group)
            else:
                dx[m] = got[0]
        ctx.saved = None
        if group is not None:
            dx = D.broadcast(dx, ranks[0], group)  # stage 0's input gradient, on every rank
        if dgroup is not None:
            p_grads = [D.all_reduce(gp, dgroup) for gp in p_grads]
        return (dx, None, None, None, *p_grads)


def pipeline_language_forward(cfg, layers, x_mb: torch.Tensor, positions_mb: torch.Tensor,
                              mesh, *, stage_axis: str = "stage", remat: str = "none",
                              attn_mask=None) -> torch.Tensor:
    """GPipe forward over the decoder stack: microbatch m's carry visits
    stage s at step m + s. `layers` are this stage's layers (`split_stages`),
    x_mb [M, T, D] and positions_mb [M, 3, T] the same on every rank.
    Returns [M, T, D] pre-final-norm hidden states on every rank. Its
    arithmetic is the training stack's (`language.language_forward_train`),
    layer by layer on the same carry. attn_mask: only None (causal)."""
    if attn_mask is not None:
        raise ValueError("pipeline_language_forward: only the causal mask (attn_mask=None)")
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    S = mesh.size(stage_axis)
    if len(layers) * S != cfg.num_hidden_layers:
        raise ValueError(f"{len(layers)} layers a stage over {S} stages is not the model's "
                         f"{cfg.num_hidden_layers}: cut the model with split_stages")
    dp = "data" if "data" in mesh else None
    dgroup = mesh.group(dp) if dp else None
    if dp and x_mb.shape[0] % mesh.size(dp):
        raise ValueError(f"microbatches {x_mb.shape[0]} must divide the data axis "
                         f"{mesh.size(dp)}")
    x_loc = take(x_mb, dgroup, 0)
    pos = positions_mb.chunk(mesh.size(dp) if dp else 1, 0)[mesh.index(dp) if dp else 0]
    inv_freq = torch.from_numpy(make_inv_freq(cfg.head_dim, cfg.rope_theta)).to(x_mb.device)
    cs = [mrope_cos_sin(p, inv_freq, cfg.mrope_section) for p in pos]
    cos_mb, sin_mb = torch.stack([c for c, _ in cs]), torch.stack([s for _, s in cs])
    params = [p for layer in layers for p in layer.parameters() if p.requires_grad]
    run = (cfg, layers, remat, mesh.ranks(stage_axis), mesh.group(stage_axis), dgroup)
    out = _Pipeline.apply(x_loc, cos_mb, sin_mb, run, *params)
    return gather_take(out, dgroup, 0)


def sft_loss_pp(cfg, model, batch: Dict[str, torch.Tensor], mesh, *, stage_axis: str = "stage",
                remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline-parallel twin of train.step.sft_loss (the same batch schema
    and loss): each batch example is one microbatch. Embedding, vision
    scatter, final norm and the CE head run replicated outside the
    pipeline. The model must hold this stage's layers (`split_stages`)."""
    from ..train.step import IGNORE_INDEX, _scatter_drop, fused_linear_ce

    tcfg, lm = cfg.text, model.text
    ids, labels = batch["input_ids"], batch["labels"]
    ve, vs = batch.get("vis_embeds"), batch.get("vis_slots")
    xs = []
    for b in range(ids.shape[0]):
        x = language.embed_tokens(tcfg, lm, ids[b].long())
        if ve is not None:
            x = _scatter_drop(x, vs[b], ve[b])
        xs.append(x)
    hidden = pipeline_language_forward(tcfg, lm.layers, torch.stack(xs), batch["positions"],
                                       mesh, stage_axis=stage_axis, remat=remat)
    w = language.head_weight(tcfg, lm)
    totals, counts = [], []
    for b in range(ids.shape[0]):
        h = lm.final_ln(hidden[b])
        targets = labels[b, 1:]
        mask = targets != IGNORE_INDEX
        safe_t = torch.where(mask, targets, torch.zeros_like(targets))
        totals.append(fused_linear_ce(h[:-1], w, safe_t, mask))
        counts.append(mask.sum())
    count = torch.stack(counts).sum().clamp_min(1)
    return torch.stack(totals).sum() / count, count


def make_train_step_pp(cfg, optimizer, mesh, *, stage_axis: str = "stage", remat: str = "none"):
    """Pipeline-parallel twin of train.step.make_train_step (vision frozen,
    text parameters trained): step(model, opt_state, batch) -> (opt_state,
    metrics), the model cut by `split_stages`; the optimizer clips by, and
    grad_norm reports, the whole model's norm (`stage_norm_fn`)."""
    from ..train.step import apply_updates, trained_params

    def step(model, opt_state, batch):
        params = trained_params(model)
        loss, count = sft_loss_pp(cfg, model, batch, mesh, stage_axis=stage_axis, remat=remat)
        grads = torch.autograd.grad(loss, params)
        norm = stage_norm_fn(model, mesh, stage_axis)
        getattr(optimizer, "opt", optimizer).norm_fn = norm
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        metrics = {"loss": loss.detach(), "labeled_tokens": count, "grad_norm": norm(grads)}
        return opt_state, metrics

    return step


def stage_norm_fn(model, mesh, stage_axis: str = "stage"):
    """The whole model's gradient norm from this stage's gradients (in
    `model.text.parameters()` order): the layers' squares summed over the
    stage line, the replicated parameters' counted once."""
    layer_ids = {id(p) for p in model.text.layers.parameters()}
    axes = [(stage_axis,) if id(p) in layer_ids else () for p in model.text.parameters()]
    return lambda grads: D.sharded_norm(grads, axes, mesh)
