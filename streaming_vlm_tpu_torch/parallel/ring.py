"""Sequence (context) parallelism for training: ring attention over a 'seq'
mesh axis.

Port of streaming_vlm_tpu/parallel/ring.py. The sequence dim of every
activation splits over 'seq' (and the batch over 'data', where the mesh has
it); the only op that talks across ranks is attention, computed as ring
attention (Liu et al., arXiv:2310.01889): rank s holds query / key block s
of S, and the K/V blocks travel the ring s -> s + 1 (`distributed.shift`).

`ring_attention` is a torch.autograd.Function whose memory is O(T / S) per
rank, forward and backward:

* forward: step 0 is the rank's own block, causal: K1 at visible 0 with its
  log-sum-exp (as `ops.attention._TrainAttention`); a block wholly before
  the queries goes through K1's full-block mode
  (`ops.attention.full_block_attention`), also with its log-sum-exp; a
  block wholly after them is skipped, not launched (in JAX it adds
  exp(NEG_INF - m) = 0). The (out, lse) pairs merge in f32 PyTorch ops;
* backward: the standard ring backward. K1-bwd runs per block (causal on
  the own block, its full-block mode on earlier ones) with the *global*
  out and lse, so that D = rowsum(dO . O) and P = exp2(s2 - lse2) are the
  whole softmax's; dK and dV travel the ring with K and V and arrive back
  at their owner after S hops (ppermute's transpose is the reverse hop:
  here the gradients ride the same direction one extra hop).

Layer weights are replicated over the ring (and 'data'); each rank's
gradient covers its own tokens, so every use of a weight passes through
`tp.copy_to` over those axes (the identity; the gradient summed), and `sft_loss_sp`'s gradients are the whole
gradient on every rank, as jax.grad of the JAX function gives them. The
embedding, vision scatter and CE head run replicated on the whole sequence
(the hidden states are gathered, each rank taking back its part of their
gradient). On CPU tensors every kernel runs its plain version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..models.qwen25_vl import language
from ..models.qwen25_vl.rope import mrope_cos_sin
from ..ops.attention import (
    attention_bwd,
    full_block_attention,
    streaming_prefill_attention,
    train_attention_plain,
)
from . import distributed as D
from .tp import copy_to, gather_take, take


def _causal_block(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's own block: causal attention with each row's log2-space
    log-sum-exp: K1 at visible 0 on the card, its plain version on the CPU.
    Returns (out [T, H, hd], lse2 f32 [T, H])."""
    T, H, hd = q.shape
    if q.device.type == "cpu":
        out, lse2 = train_attention_plain(q, k, v, return_lse=True)
        return out.reshape(T, H, hd), lse2
    lse2 = torch.empty(T, H, dtype=torch.float32, device=q.device)
    out = streaming_prefill_attention(q, k, v, None, None, k, v, 0, lse=lse2)
    return out, lse2


def _earlier_block(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """A key block wholly before the queries: K1's full-block mode."""
    lse2 = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return full_block_attention(q, k, v, lse=lse2), lse2


def merge_blocks(o_a, l_a, o_b, l_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two normalised attention outputs over disjoint key sets, [T, H, hd],
    with their log2-space log-sum-exps [T, H], merged into the output over
    the union (f32)."""
    m = torch.maximum(l_a, l_b)
    wa, wb = torch.exp2(l_a - m), torch.exp2(l_b - m)
    den = wa + wb
    out = (o_a.float() * (wa / den)[..., None]) + (o_b.float() * (wb / den)[..., None])
    return out, m + torch.log2(den)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ranks, group):
        S = len(ranks)
        s = ranks.index(torch.distributed.get_rank()) if group is not None else 0
        T, H, hd = q.shape
        out, lse = _causal_block(q, k, v)
        out = out.float()
        kb, vb = k, v
        for step in range(1, S):
            kb, vb = D.shift([kb, vb], ranks, group, 1)
            if (s - step) % S < s:  # wholly before the queries; else wholly after: skipped
                o_i, l_i = _earlier_block(q, kb, vb)
                out, lse = merge_blocks(out, lse, o_i, l_i)
        out = out.to(v.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ranks, ctx.group, ctx.s = ranks, group, s
        return out.reshape(T, H * hd)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        ranks, group, s = ctx.ranks, ctx.group, ctx.s
        S = len(ranks)
        d_out = grad.reshape(out.shape).to(out.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        for step in range(S):
            blk = (s - step) % S
            if blk <= s:
                dq_i, dk_i, dv_i = attention_bwd(q, kb, vb, out, lse, d_out, causal=blk == s)
                dq += dq_i.float()
                dkb += dk_i.float()
                dvb += dv_i.float()
            if step < S - 1:
                kb, vb, dkb, dvb = D.shift([kb, vb, dkb, dvb], ranks, group, 1)
            else:  # the last hop takes dK and dV home
                dkb, dvb = D.shift([dkb, dvb], ranks, group, 1)
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None


def ring_attention(q_rot, k_rot, v, mesh, seq_axis: str = "seq") -> torch.Tensor:
    """Causal GQA attention of this rank's query block q_rot [Tl, H, hd]
    over the whole sequence's keys, whose blocks k_rot, v [Tl, Hkv, hd] are
    held one by each rank of the `seq_axis` line in order. Returns [Tl, H *
    hd] in v's dtype."""
    return _RingAttention.apply(q_rot.contiguous(), k_rot.contiguous(), v.contiguous(),
                                mesh.ranks(seq_axis), mesh.group(seq_axis))


class _LayerSP(nn.Module):
    """One decoder layer on a sequence shard, ring attention as the mixing
    op (JAX `_layer_body_sp`: the same projections, norms and residuals)."""

    def __init__(self, layer, cfg, mesh, seq_axis):
        super().__init__()
        self.layer, self.cfg, self.mesh, self.seq_axis = layer, cfg, mesh, seq_axis

    def forward(self, hidden, cos, sin):
        q, _, k_rot, v = language._qkv(self.cfg, hidden, self.layer, cos, sin)
        attn = ring_attention(q, k_rot, v, self.mesh, self.seq_axis)
        return language._layer_tail(self.layer, hidden, attn)


def _dp_axis(mesh):
    return "data" if "data" in mesh else None


def sp_language_forward(cfg, lm, x: torch.Tensor, positions: torch.Tensor, mesh, *,
                        seq_axis: str = "seq", remat: str = "none") -> torch.Tensor:
    """Sequence-parallel decoder stack: x [B, T, D] embeddings and positions
    [B, 3, T] (the same on every rank); T splits over `seq_axis` (and B over
    'data' if the mesh has it); per-layer ring attention. Returns the whole
    post-final-norm hidden [B, T, D] on every rank (gathered)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    B, T, _ = x.shape
    S = mesh.size(seq_axis)
    if T % S:
        raise ValueError(f"seq len {T} must divide the seq axis {S}")
    dp = _dp_axis(mesh)
    if dp and B % mesh.size(dp):
        raise ValueError(f"batch {B} must divide the data axis {mesh.size(dp)}")
    sg, dg = mesh.group(seq_axis), mesh.group(dp) if dp else None
    x_loc = take(take(x, dg, 0), sg, 1)
    pos_loc = positions.chunk(mesh.size(dp) if dp else 1, 0)[mesh.index(dp) if dp else 0]
    pos_loc = pos_loc.chunk(S, 2)[mesh.index(seq_axis)]
    rep = mesh.group(tuple(a for a in (dp, seq_axis) if a))
    kw = {}
    if remat == "dots":
        import functools

        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            language._dots_saveable)
    outs = []
    for b in range(x_loc.shape[0]):
        cos, sin = mrope_cos_sin(pos_loc[b], lm.inv_freq(x.device), cfg.mrope_section)
        h = x_loc[b]
        for layer in lm.layers:
            body = _LayerSP(layer, cfg, mesh, seq_axis)
            # each rank's gradient covers its tokens: summed over the replicas
            params = {f"layer.{n}": copy_to(p, rep) if p.requires_grad else p
                      for n, p in layer.named_parameters()}

            def fn(h, cos=cos, sin=sin, body=body, params=params):
                return torch.func.functional_call(body, params, (h, cos, sin))

            if remat == "none":
                h = fn(h)
            else:
                h = torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False, **kw)
        outs.append(h)
    hidden = gather_take(gather_take(torch.stack(outs), sg, 1), dg, 0)
    return lm.final_ln(hidden)  # on the whole (replicated) sequence


def sft_loss_sp(cfg, model, batch: Dict[str, torch.Tensor], mesh, *, seq_axis: str = "seq",
                remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel twin of train.step.sft_loss (the same batch schema
    and loss): embedding and vision scatter per example before the shard,
    the fused CE head on the gathered hidden states. Returns (mean loss over
    labeled tokens, labeled-token count), the same on every rank; its
    gradients are the whole gradient on every rank."""
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
    hidden = sp_language_forward(tcfg, lm, torch.stack(xs), batch["positions"], mesh,
                                 seq_axis=seq_axis, remat=remat)
    w = language.head_weight(tcfg, lm)
    totals, counts = [], []
    for b in range(ids.shape[0]):
        targets = labels[b, 1:]
        mask = targets != IGNORE_INDEX
        safe_t = torch.where(mask, targets, torch.zeros_like(targets))
        totals.append(fused_linear_ce(hidden[b, :-1], w, safe_t, mask))
        counts.append(mask.sum())
    count = torch.stack(counts).sum().clamp_min(1)
    return torch.stack(totals).sum() / count, count
