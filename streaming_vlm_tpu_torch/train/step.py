"""SFT training step (streaming-aligned next-token objective) on the port.

Port of streaming_vlm_tpu/train/step.py: frozen vision tower, bf16
forward, label mask = assistant spans only (-100 elsewhere), and a
bounded-memory linear cross-entropy that never materialises [T, vocab]
logits: `fused_linear_ce` (the loss and both gradients in one chunked
sweep, an autograd.Function; each chunk's row pass is kernel CE-row on the
card, ops/linear_ce.py) and `chunked_cross_entropy` (per-token NLLs,
checkpointed chunks). `sft_loss` runs the decoder through
`language_forward_train` (K1 forward, K1-bwd backward on the card).

The optimizer is plain tensor code that reproduces optax 0.2.6's
`chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))` and
`MultiSteps` (the JAX Trainer's), not torch.optim.AdamW, whose defaults
differ: the schedule is read at the update count before it is
incremented (the first update uses lr 0); clipping scales by (t / norm) *
max_norm only when norm >= max_norm (no 1e-6); weight decay is added to
Adam's update, then the whole is scaled by -lr; mu, nu and the accumulated
mean are kept in the parameters' dtype. Parameters are lists of tensors
(`model.text.parameters()` order); the optimizer's state is a dict of
lists of tensors and ints.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import ModelConfig
from ..models.qwen25_vl import language, vision
from ..ops.linear_ce import ce_rows
from ..ops.quant import f32_product

IGNORE_INDEX = -100

CE_CHUNK = 256  # rows per logits chunk of chunked_cross_entropy
# the fused loss+grads pass wants larger chunks: its f32 [V, D] dW
# accumulator is read and written once a chunk
FUSED_CE_CHUNK = 2048


def _fused_ce_pass(hidden, lm_head, targets, mask, *, with_grads: bool):
    """One chunked sweep computing the masked NLL sum and, with grads, both
    gradients (the JAX package's `_fused_ce_pass`): per chunk of
    FUSED_CE_CHUNK rows the f32 logits (`f32_product`: the f32 product of
    the operands, no round), CE-row (NLL; dlog = (softmax - onehot) * mask
    in place over the logits), dh = the f32 product of dlog rounded to the
    head's dtype with the head, and dW += dlog^T . hidden in f32 from the
    f32 dlog. lm_head is [V, D] (nn.Linear's layout; the JAX function takes
    its [D, V] transpose). Returns (nll_sum f32, dh [T, D] f32 or None, dw
    [V, D] f32 or None)."""
    T, D = hidden.shape
    V = lm_head.shape[0]
    cc = FUSED_CE_CHUNK
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    dh = torch.empty(T, D, dtype=torch.float32, device=hidden.device) if with_grads else None
    dw = torch.zeros(V, D, dtype=torch.float32, device=hidden.device) if with_grads else None
    for c0 in range(0, T, cc):
        hh = hidden[c0:c0 + cc]
        logits = f32_product(hh, lm_head)
        nll_sum = nll_sum + ce_rows(logits, targets[c0:c0 + cc], mask[c0:c0 + cc], with_grads).sum()
        if with_grads:  # logits now hold dlog
            dh[c0:c0 + cc] = f32_product(logits.to(lm_head.dtype), lm_head.t())
            dw.addmm_(logits.t(), hh.float())
        del logits
    return nll_sum, dh, dw


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, lm_head, targets, mask):
        with_grads = bool(ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
        nll, dh, dw = _fused_ce_pass(hidden, lm_head, targets, mask, with_grads=with_grads)
        if with_grads:  # residuals in the primals' dtypes
            ctx.save_for_backward(dh.to(hidden.dtype), dw.to(lm_head.dtype))
        return nll

    @staticmethod
    def backward(ctx, g):
        dh, dw = ctx.saved_tensors
        g = g.float()
        return (g * dh.float()).to(dh.dtype), (g * dw.float()).to(dw.dtype), None, None


def fused_linear_ce(hidden: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token NLL sum with the gradients computed in the forward
    sweep (see _fused_ce_pass): hidden [T, D], lm_head [V, D] (a tied
    model's embedding matrix: the gradient reaches it), targets [T] in range
    (mask the ignored rows), mask [T] bool. Returns an f32 scalar."""
    return _FusedLinearCE.apply(hidden, lm_head, targets, mask)


def _ce_chunk(hh, lm_head, tt):
    logits = F.linear(hh.float(), lm_head.float())
    return torch.logsumexp(logits, dim=-1) - logits.gather(1, tt[:, None])[:, 0]


def chunked_cross_entropy(
    hidden: torch.Tensor,  # [T, D]
    lm_head: torch.Tensor,  # [V, D]
    targets: torch.Tensor,  # [T] (already made safe; mask applied outside)
) -> torch.Tensor:
    """Per-token NLL [T] f32 without the full [T, V] logits: CE_CHUNK rows at
    a time under torch.utils.checkpoint, so forward and backward peak at
    [CE_CHUNK, V] (the JAX package's `chunked_cross_entropy`). Its logits
    are the f32 product of the operands' values (autograd's; no kernel: the
    trainer's loss is fused_linear_ce)."""
    outs = []
    for c0 in range(0, hidden.shape[0], CE_CHUNK):
        args = (hidden[c0:c0 + CE_CHUNK], lm_head, targets[c0:c0 + CE_CHUNK])
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(_ce_chunk, *args, use_reentrant=False))
        else:
            outs.append(_ce_chunk(*args))
    return torch.cat(outs)


def _scatter_drop(x: torch.Tensor, slots: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """x with rows `slots` set to values; slots >= len(x) are dropped (the
    JAX scatter's mode="drop"), out of place and differentiable, without a
    host sync: the dropped rows land on one extra row that is cut off."""
    T = x.shape[0]
    ext = torch.cat([x, x.new_zeros(1, x.shape[1])])
    ext = ext.index_put((slots.long().clamp(max=T),), values.to(x.dtype))
    return ext[:T]


def sft_loss(
    cfg: ModelConfig,
    model,  # models.qwen25_vl.model.Qwen25VL
    batch: Dict[str, torch.Tensor],
    remat: str = "none",
    grid_thw: Optional[Tuple[int, int, int]] = None,
    attn_q_block: Optional[int] = None,  # the CPU plain attention's row block (None: auto)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: input_ids [B, T], labels [B, T] (-100 masked), positions [B, 3,
    T] f32, and optional vis_embeds [B, n_vis, D] + vis_slots [B, n_vis]
    (vision already merged: the frozen-ViT recipe; slots >= T are dropped)
    or pixel_patches [B, S, patch_dim] + `grid_thw` to run the vision tower
    inside the loss (differentiable through model.vision; what
    freeze_vision=False needs). The tower has no kernel (its plain
    attention). Returns (mean loss over labeled tokens, labeled-token
    count). `remat` as in `language_forward_train`."""
    total, count = sft_loss_sums(cfg, model, batch, remat, grid_thw, attn_q_block)
    return total / count.clamp_min(1), count.clamp_min(1)


def sft_loss_sums(cfg: ModelConfig, model, batch: Dict[str, torch.Tensor], remat: str = "none",
                  grid_thw: Optional[Tuple[int, int, int]] = None,
                  attn_q_block: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sft_loss`'s parts: (the NLL summed over the batch's labeled tokens
    f32, their count), the count not clamped (a data-parallel rank sums
    both over the data axis before the division)."""
    tcfg, lm = cfg.text, model.text
    ve, vs, pp = batch.get("vis_embeds"), batch.get("vis_slots"), batch.get("pixel_patches")
    if ve is None and pp is not None:
        if grid_thw is None:
            raise ValueError("pixel_patches in batch need grid_thw")
        geo = model.vision.geometry([tuple(int(x) for x in grid_thw)], pp.device)
        ve = torch.stack([vision.vision_forward(cfg.vision, model.vision, p, geo) for p in pp])
    w = language.head_weight(tcfg, lm)
    totals, counts = [], []
    for b in range(batch["input_ids"].shape[0]):
        x = language.embed_tokens(tcfg, lm, batch["input_ids"][b].long())
        if ve is not None:
            x = _scatter_drop(x, vs[b], ve[b])
        hidden = language.language_forward_train(
            tcfg, lm, x, batch["positions"][b], remat=remat, attn_q_block=attn_q_block)
        targets = batch["labels"][b, 1:]  # next-token shift
        mask = targets != IGNORE_INDEX
        safe_t = torch.where(mask, targets, torch.zeros_like(targets))
        totals.append(fused_linear_ce(hidden[:-1], w, safe_t, mask))
        counts.append(mask.sum())
    return torch.stack(totals).sum(), torch.stack(counts).sum()


# ---------------------------------------------------------------------------
# Optimizer: optax 0.2.6's clip_by_global_norm + adamw(warmup cosine) and
# MultiSteps, in its order
# ---------------------------------------------------------------------------


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def warmup_cosine_lr(count: int, peak: float, warmup: int, decay_steps: int) -> np.float32:
    """optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay_steps) at
    `count`, in optax's f32 arithmetic: a linear ramp from 0 over `warmup`
    counts, then a cosine to 0 at decay_steps."""
    f = np.float32
    if count < warmup:
        frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
        return f(0.0 - peak) * frac + f(peak)
    span = float(decay_steps - warmup)
    c = min(f(count - warmup), f(span))
    cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(span)))
    return f(peak) * cosine


def _weak(x: float, t: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type takes it: in the tensor's dtype."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps, weight_decay)) over a list of tensors. update(grads, state,
    params) returns (updates, state); the schedule is read at the update
    count before its increment. mu and nu are updated in place (the state
    returned is the one passed in), so that no second copy of them is held:
    the same values as optax's, whose scalars this applies in each
    tensor's dtype, as JAX does with weak-typed Python scalars."""

    def __init__(self, learning_rate: float, weight_decay: float, grad_clip: float,
                 warmup_steps: int, total_steps: int, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.grad_clip = grad_clip
        # decay_steps must exceed warmup (optax requires a positive decay span)
        self.warmup = max(warmup_steps, 1)
        self.decay_steps = max(total_steps, self.warmup + 1)
        self.b1, self.b2, self.eps = b1, b2, eps
        # the clip's norm: the global norm of the gradients this rank holds;
        # a sharded trainer sets the norm over every rank's shards
        self.norm_fn = global_norm

    def lr(self, count: int) -> np.float32:
        return warmup_cosine_lr(count, self.learning_rate, self.warmup, self.decay_steps)

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        g_norm = self.norm_fn(grads)
        clip = bool(g_norm >= self.grad_clip)
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** count  # optax: decay ** count in f32
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** count
        step = -self.lr(state["count"])
        updates = []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            if clip:
                g = (g / g_norm.to(g.dtype)) * _weak(self.grad_clip, g)
            # (1 - b) g^k + b m, the sum's operands in optax's order
            mu.mul_(_weak(self.b1, mu)).add_(_weak(1 - self.b1, g) * g)
            nu.mul_(_weak(self.b2, nu)).add_(_weak(1 - self.b2, g) * (g * g))
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + _weak(self.eps, nu))
            u = u + _weak(self.weight_decay, p) * p
            updates.append(torch.tensor(step, dtype=u.dtype, device=u.device) * u)
        state["count"] = count
        return updates, state


class MultiSteps:
    """optax.MultiSteps(opt, every_k) with use_grad_mean: each call folds the
    gradients into a running mean acc + (g - acc) / (k + 1) (k the mini-step,
    in the parameters' dtype; in place) and, on the every_k-th, runs the
    inner optimizer on the mean and clears it. Between boundaries its
    updates are zero, returned as None (`apply_updates` leaves the
    parameters as they are)."""

    def __init__(self, opt: AdamW, every_k: int):
        self.opt, self.every_k = opt, int(every_k)

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.opt.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads, state, params):
        n = state["mini_step"]
        for a, g in zip(state["acc"], grads):
            a.add_((g - a) / (n + 1))
        if n < self.every_k - 1:
            state["mini_step"] = n + 1
            return None, state
        updates, state["inner"] = self.opt.update(state["acc"], state["inner"], params)
        for a in state["acc"]:
            a.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return updates, state


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates) -> None:
    """params += updates in place, in each parameter's dtype
    (optax.apply_updates); None: no update."""
    if updates is None:
        return
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


def make_optimizer(
    learning_rate: float = 1e-5,
    weight_decay: float = 0.0,
    grad_clip: float = 1.0,
    warmup_steps: int = 0,
    total_steps: int = 10000,
) -> AdamW:
    return AdamW(learning_rate, weight_decay, grad_clip, warmup_steps, total_steps)


def trained_params(model, freeze_vision: bool = True) -> List[torch.Tensor]:
    """The tensors a step updates, in a fixed order: model.text's parameters
    (freeze_vision, the reference recipe), else every parameter (the
    tower's included). Sets requires_grad on them and off on the rest."""
    params = list(model.text.parameters()) if freeze_vision else list(model.parameters())
    keep = {id(p) for p in params}
    for p in model.parameters():
        p.requires_grad_(id(p) in keep)
    return params


def make_train_step(
    cfg: ModelConfig, optimizer, freeze_vision: bool = True, remat: str = "none",
    grid_thw: Optional[Tuple[int, int, int]] = None,
):
    """A train step step(model, opt_state, batch) -> (opt_state, metrics)
    that updates the model's parameters in place. freeze_vision=True
    differentiates and updates only model.text (opt_state initialised over
    `trained_params(model)`); freeze_vision=False the whole model, the
    tower included, and the batch must carry pixel_patches (+ grid_thw
    here), so the tower runs inside the differentiated loss. metrics:
    loss, labeled_tokens, grad_norm (the micro-batch's gradient norm)."""

    def step(model, opt_state, batch):
        params = trained_params(model, freeze_vision)
        loss, count = sft_loss(cfg, model, batch, remat=remat, grid_thw=grid_thw)
        grads = torch.autograd.grad(loss, params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        metrics = {"loss": loss.detach(), "labeled_tokens": count, "grad_norm": global_norm(grads)}
        return opt_state, metrics

    return step
