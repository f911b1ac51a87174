"""Qwen2.5-VL language model (decoder stack) in PyTorch.

Port of streaming_vlm_tpu/models/qwen25_vl/language.py. Layers are an
`nn.ModuleList` walked by a Python loop (the JAX package scans stacked
weights). Weights are stored as `nn.Linear` ([out, in]); the bridge in
models/bridge.py transposes the JAX [in, out] layout. With W8A8 weights
(`ops.quant.quantize_model`) the seven projections of each layer and the
lm_head are `ops.quant.QLinear` (kernel K5), with W4A8 weights
(`quantize_model(bits=4)`) `ops.quant.QLinear4` (qdot4: kernel K5-int4
below 32 rows), called the same way.

The KV arena is a pair of [L, C, Hkv, hd] tensors holding UN-rotated K, or,
with `kv_quant="int8"`, a pair of `ops.quant.QuantKV` (int8 [L, C, Hkv, hd]
+ f32 [L, C, Hkv] scales). `language_forward_streaming` reads it and
returns the block's new K/V as [L, T, Hkv, hd] for the caller to merge:

* prefill mode (no `extra`) runs kernel K1 (`streaming_prefill_attention`)
  over each layer's arena slice, dequantized to the compute dtype (one
  [C, Hkv, hd] transient), pre-rotated or raw and rotated in the kernel,
  plus the block's own causal keys;
* decode mode (`extra` = the rotated decode delta, T == 1) runs, over a
  pre-rotated arena, kernel K2 (`streaming_decode_attention_full`) with V
  dequantized per layer; over a raw arena, kernel K3
  (`streaming_decode_attention_int8`), which reads the arena in its storage
  form and dequantizes and rotates in the kernel;
* verify mode (`extra` and T > 1: a speculative-decoding round's T tokens
  of one stream) runs kernel K2-verify (`streaming_verify_attention`) over
  the pre-rotated float arena, the delta and the T tokens' causal self
  rows.

`language_forward_train` is the training stack: causal self-attention
through `train_attention` (K1 forward, K1-bwd backward on the card),
differentiable, with layer remat "none", "full" or "dots".

`language_forward_lanes` is the multi-stream form: B streams' [B, L, C,
Hkv, hd] arenas in one pass, [B * T, D] rows through every projection (one
weight read for all lanes) and the kernels' lane forms; the one-stream
`language_forward_streaming` is that form at B = 1.

On CPU tensors the kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ...config import TextConfig
from ...ops.attention import (
    gqa_attention_multi,
    lane_lengths,
    streaming_decode_attention_full,
    streaming_decode_attention_int8,
    streaming_prefill_attention,
    streaming_verify_attention,
    train_attention,
)
from ...ops.quant import (
    Arena,
    QUANTIZED_LINEARS,
    QuantKV,
    as_float,
    f32_product,
    lanes_layer,
    storage,
    with_lanes,
)
from .rope import apply_rope, make_inv_freq, mrope_cos_sin


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * scale.float()).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **factory))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def swiglu(x: torch.Tensor, gate: nn.Module, up: nn.Module, down: nn.Module) -> torch.Tensor:
    return down(F.silu(gate(x)) * up(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, **factory):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        H, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.input_ln = RMSNorm(D, cfg.rms_norm_eps, **factory)
        self.q_proj = nn.Linear(D, H * hd, **factory)
        self.k_proj = nn.Linear(D, Hkv * hd, **factory)
        self.v_proj = nn.Linear(D, Hkv * hd, **factory)
        self.o_proj = nn.Linear(H * hd, D, bias=False, **factory)
        self.post_ln = RMSNorm(D, cfg.rms_norm_eps, **factory)
        self.gate_proj = nn.Linear(D, I, bias=False, **factory)
        self.up_proj = nn.Linear(D, I, bias=False, **factory)
        self.down_proj = nn.Linear(I, D, bias=False, **factory)


class LanguageModel(nn.Module):
    def __init__(self, cfg: TextConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, **factory) for _ in range(cfg.num_hidden_layers)
        )
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **factory)
        self.lm_head = (
            None
            if cfg.tie_word_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory)
        )
        self._inv_freq: Dict[torch.device, torch.Tensor] = {}
        # the process group over which a tensor-parallel lm_head's vocab is
        # split (parallel/tp.py): lm_logits gathers the logits over it
        self.vocab_group = None

    def inv_freq(self, device: torch.device) -> torch.Tensor:
        """RoPE inverse frequencies (host numpy, uploaded once per device)."""
        if device not in self._inv_freq:
            f = make_inv_freq(self.cfg.head_dim, self.cfg.rope_theta)
            self._inv_freq[device] = torch.from_numpy(f).to(device)
        return self._inv_freq[device]


# ---------------------------------------------------------------------------
# Layer math
# ---------------------------------------------------------------------------


def _qkv(cfg: TextConfig, hidden, layer: DecoderLayer, q_cos, q_sin):
    """Norm + projections + RoPE. Returns (q_rot [T,H,hd], k_new [T,Hkv,hd]
    raw, k_new_rot, v_new)."""
    T = hidden.shape[0]
    H, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    x = layer.input_ln(hidden)
    q = layer.q_proj(x).view(T, H, hd)
    k_new = layer.k_proj(x).view(T, Hkv, hd)
    v_new = layer.v_proj(x).view(T, Hkv, hd)
    cos, sin = q_cos[:, None, :], q_sin[:, None, :]
    return apply_rope(q, cos, sin), k_new, apply_rope(k_new, cos, sin), v_new


def _layer_tail(layer: DecoderLayer, hidden, attn):
    hidden = hidden + layer.o_proj(attn)
    x = layer.post_ln(hidden)
    return hidden + swiglu(x, layer.gate_proj, layer.up_proj, layer.down_proj)


def _layer_body(cfg: TextConfig, hidden: torch.Tensor, layer: DecoderLayer, *, q_cos, q_sin,
                self_mask):
    """One decoder layer over the block's own K/V, plain attention under
    self_mask [T, T] (the oracle's)."""
    q, _, k_new_rot, v_new = _qkv(cfg, hidden, layer, q_cos, q_sin)
    attn = gqa_attention_multi(q, [(k_new_rot, v_new, self_mask)])
    return _layer_tail(layer, hidden, attn)


def language_forward(
    cfg: TextConfig,
    lm: LanguageModel,
    inputs_embeds: torch.Tensor,  # [T, D]
    positions: torch.Tensor,  # [3, T] float32
    attn_mask: Optional[torch.Tensor] = None,  # [T, T] bool; default causal
) -> torch.Tensor:
    """Offline decoder stack with plain causal self-attention (the test
    oracle). Returns hidden [T, D] post-final-norm."""
    T = inputs_embeds.shape[0]
    q_cos, q_sin = mrope_cos_sin(positions, lm.inv_freq(positions.device), cfg.mrope_section)
    if attn_mask is None:
        attn_mask = torch.ones(T, T, dtype=torch.bool, device=inputs_embeds.device).tril()
    hidden = inputs_embeds
    for layer in lm.layers:
        hidden = _layer_body(cfg, hidden, layer, q_cos=q_cos, q_sin=q_sin, self_mask=attn_mask)
    return lm.final_ln(hidden)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of the
    plain matrix products (the projections: aten.mm / addmm, no batch dims),
    recompute everything else, as JAX's dots_with_no_batch_dims_saveable."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def language_forward_train(
    cfg: TextConfig,
    lm: LanguageModel,
    inputs_embeds: torch.Tensor,  # [T, D]
    positions: torch.Tensor,  # [3, T] float32
    remat: str = "none",  # {"none", "full", "dots"} activation checkpointing
    attn_q_block: Optional[int] = None,  # None: auto (512 at T >= 2048, else 0)
) -> torch.Tensor:
    """Training decoder stack, differentiable: causal self-attention through
    `ops.attention.train_attention` (on the card K1 forward with each row's
    log-sum-exp and K1-bwd backward). Returns hidden [T, D] post-final-norm.
    Port of the JAX package's `language_forward` (language.py:348-397).

    `remat` checkpoints each layer (torch.utils.checkpoint, non-reentrant):
    "full" saves only the [T, D] carry between layers and recomputes the
    rest in the backward (the forward, K1 included, runs twice), "dots"
    also saves the outputs of the projections (a selective-checkpoint
    policy, JAX's dots_with_no_batch_dims_saveable). `attn_q_block` is the
    CPU plain attention's row block (as in JAX: None = 512 at T >= 2048,
    else 0 = the naive [T, T] logits); the kernels hold O(T) memory whatever
    it is."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    T = inputs_embeds.shape[0]
    q_cos, q_sin = mrope_cos_sin(positions, lm.inv_freq(positions.device), cfg.mrope_section)
    if attn_q_block is None:
        attn_q_block = 512 if T >= 2048 else 0

    def layer_fn(hidden, layer):
        q, _, k_rot, v = _qkv(cfg, hidden, layer, q_cos, q_sin)
        return _layer_tail(layer, hidden, train_attention(q, k_rot, v, attn_q_block))

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts, _dots_saveable)
    hidden = inputs_embeds
    for layer in lm.layers:
        if remat == "none":
            hidden = layer_fn(hidden, layer)
        else:
            hidden = torch.utils.checkpoint.checkpoint(layer_fn, hidden, layer,
                                                       use_reentrant=False, **kw)
    return lm.final_ln(hidden)


def language_forward_streaming(
    cfg: TextConfig,
    lm: LanguageModel,
    inputs_embeds: torch.Tensor,  # [T, D]
    q_positions: torch.Tensor,  # [3, T] float32
    *,
    arena: Tuple[Arena, Arena],  # READ-ONLY [L, C, Hkv, hd] x2, float or QuantKV
    arena_positions: Optional[torch.Tensor] = None,  # [3, C] (raw-K arena)
    visible_len: int,  # arena slots < visible_len are attendable
    arena_rotated: bool = False,  # arena K already rotated for these positions
    extra: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [L, E, Hkv, hd] x2
    extra_visible: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Streaming decoder stack over a read-only KV arena, for one stream.
    Returns (hidden [T, D] post-final-norm, (k_block, k_block_rot, v_block)
    each [L, T, Hkv, hd] in the compute dtype). The lane form at B = 1
    (`language_forward_lanes`)."""
    hidden, blocks = language_forward_lanes(
        cfg, lm, inputs_embeds[None], q_positions[None],
        arena=tuple(with_lanes(a) for a in arena),
        arena_positions=None if arena_positions is None else arena_positions[None],
        visible_len=[int(visible_len)], arena_rotated=arena_rotated,
        extra=None if extra is None else tuple(e[None] for e in extra),
        extra_visible=extra_visible,
    )
    return hidden[0], tuple(b[0] for b in blocks)


def language_forward_lanes(
    cfg: TextConfig,
    lm: LanguageModel,
    inputs_embeds: torch.Tensor,  # [B, T, D]
    q_positions: torch.Tensor,  # [B, 3, T] float32
    *,
    arena: Optional[Tuple[Arena, Arena]],  # READ-ONLY [B, L, C, Hkv, hd] x2, float or QuantKV
    arena_positions: Optional[torch.Tensor] = None,  # [B, 3, C] (raw-K arena)
    visible_len,  # B host ints, or (decode) an int32 [B] tensor on the device
    max_visible: Optional[int] = None,  # decode with a device tensor: its largest (host)
    arena_rotated: bool = False,
    extra: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [B, L, E, Hkv, hd] x2
    extra_visible: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Streaming decoder stack over B independent streams' read-only KV
    arenas, in one pass: every projection, norm and MLP runs once over the
    [B * T, D] rows of all lanes (one read of each weight), and each layer's
    attention is one lane-form kernel launch. Returns (hidden [B, T, D]
    post-final-norm, (k_block, k_block_rot, v_block) each [B, L, T, Hkv,
    hd] in the compute dtype).

    Prefill mode (no `extra`): K1 over each lane's arena (pre-rotated, or
    raw and rotated in the kernel from `arena_positions`) + its causal
    block, visible_len host ints. With `arena=None` (prefill mode, every
    visible length 0: B independent causal sequences, the batched MCQ
    forward) no arena exists; K1 is given each layer's own K/V block in its
    place, which it never reads at visible 0. Decode mode: `extra` is the ROTATED
    decode delta with rows < `extra_visible` visible and T == 1; K2 over a
    pre-rotated arena, K3 over a raw one, the lanes' lengths an int32
    device tensor (with max_visible) or host ints. An int8 arena is
    dequantized per layer (K1, K2) or in the kernel (K3). Verify mode
    (`extra`, T > 1, one lane, a host length): K2-verify, token t seeing
    the delta rows < extra_visible and the block's tokens <= t; it takes a
    pre-rotated arena whose K is float (ValueError for a raw arena or a
    requantized rotated copy, rot_quant="int8")."""
    B, T, D = inputs_embeds.shape
    H, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cdt = inputs_embeds.dtype  # compute dtype of dequantized arena slices
    inv_freq = lm.inv_freq(inputs_embeds.device)
    qp = q_positions.transpose(0, 1).reshape(3, B * T)
    q_cos, q_sin = mrope_cos_sin(qp, inv_freq, cfg.mrope_section)  # [B * T, hd / 2]
    outs: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
    hidden = inputs_embeds.reshape(B * T, D)

    def lane_rows(x):  # [B * T, heads, hd] -> [B, T, heads, hd]
        return x.view(B, T, *x.shape[1:])

    if extra is None:
        acos2 = asin2 = None
        if arena is None and any(lane_lengths(visible_len, B)):
            raise ValueError("arena=None takes visible length 0 on every lane")
        if arena is not None and not arena_rotated:
            C = arena_positions.shape[-1]
            ap = arena_positions.transpose(0, 1).reshape(3, B * C)
            a_cos, a_sin = mrope_cos_sin(ap, inv_freq, cfg.mrope_section)
            acos2 = torch.cat([a_cos, a_cos], dim=-1).view(B, C, hd)
            asin2 = torch.cat([a_sin, a_sin], dim=-1).view(B, C, hd)
        for l, layer in enumerate(lm.layers):
            q, k_new, k_new_rot, v_new = _qkv(cfg, hidden, layer, q_cos, q_sin)
            if arena is None:  # visible 0: the block stands in for the arena
                ak, av = lane_rows(k_new_rot), lane_rows(v_new)
            else:
                ak = as_float(lanes_layer(arena[0], l), cdt)
                av = as_float(lanes_layer(arena[1], l), cdt)
            attn = streaming_prefill_attention(
                lane_rows(q), ak, av, acos2, asin2, lane_rows(k_new_rot), lane_rows(v_new),
                visible_len,
            ).reshape(B * T, H * hd)
            hidden = _layer_tail(layer, hidden, attn)
            outs.append((k_new, k_new_rot, v_new))
    elif T > 1:
        if not arena_rotated or isinstance(arena[0], QuantKV):
            raise ValueError(
                "verify mode (T > 1 tokens over the decode delta) reads a pre-rotated float "
                "arena: a raw arena (prerotate_arena=False) or a rotated copy requantized to "
                "int8 (rot_quant='int8') is not supported")
        if B != 1 or isinstance(visible_len, torch.Tensor):
            raise ValueError("verify mode takes one lane and a host visible length")
        vis = int(np.asarray(visible_len).reshape(-1)[0])
        e_delta = extra[0].shape[2]
        for l, layer in enumerate(lm.layers):
            q, k_new, k_new_rot, v_new = _qkv(cfg, hidden, layer, q_cos, q_sin)
            out = streaming_verify_attention(
                q, arena[0][0, l], as_float(lanes_layer(arena[1], l), cdt)[0],
                torch.cat([extra[0][0, l], k_new_rot]), torch.cat([extra[1][0, l], v_new]),
                vis, extra_visible, e_delta=e_delta)
            hidden = _layer_tail(layer, hidden, out.reshape(T, H * hd))
            outs.append((k_new, k_new_rot, v_new))
    else:
        vis_kw = dict(max_visible=max_visible) if isinstance(visible_len, torch.Tensor) else {}
        if not isinstance(visible_len, torch.Tensor) and np.ndim(visible_len):
            visible_len = _host_lengths(visible_len, inputs_embeds.device, vis_kw)
        if not arena_rotated:
            pos_t = arena_positions.float().transpose(1, 2).contiguous()  # [B, C, 3], once
        for l, layer in enumerate(lm.layers):
            ak, av = lanes_layer(arena[0], l), lanes_layer(arena[1], l)
            q, k_new, k_new_rot, v_new = _qkv(cfg, hidden, layer, q_cos, q_sin)
            ks = torch.cat([extra[0][:, l], lane_rows(k_new_rot)], dim=1)
            vs = torch.cat([extra[1][:, l], lane_rows(v_new)], dim=1)
            e_delta = ks.shape[1] - 1
            if arena_rotated:
                out = streaming_decode_attention_full(
                    q, as_float(ak, cdt), as_float(av, cdt), ks, vs, visible_len, extra_visible,
                    e_delta=e_delta, **vis_kw)
            else:
                (kq, kscale), (vq, vscale) = storage(ak), storage(av)
                out = streaming_decode_attention_int8(
                    q, kq, kscale, vq, vscale, pos_t, ks, vs, visible_len, extra_visible,
                    e_delta=e_delta, mrope_section=cfg.mrope_section,
                    rope_theta=cfg.rope_theta, **vis_kw)
            hidden = _layer_tail(layer, hidden, out.reshape(B, H * hd))
            outs.append((k_new, k_new_rot, v_new))
    k_block, k_block_rot, v_block = (
        torch.stack([lane_rows(x) for x in xs], dim=1) for xs in zip(*outs)
    )
    return lm.final_ln(hidden).view(B, T, D), (k_block, k_block_rot, v_block)


def _host_lengths(lengths, device, vis_kw: dict):
    """B host lengths for a decode kernel's lane form: one int when they are
    equal, else an int32 tensor on the device (and its largest in vis_kw)."""
    lengths = [int(v) for v in lengths]
    if len(set(lengths)) == 1:
        return lengths[0]
    vis_kw["max_visible"] = max(lengths)
    return torch.tensor(lengths, dtype=torch.int32).to(device)


def embed_tokens(cfg: TextConfig, lm: LanguageModel, input_ids: torch.Tensor) -> torch.Tensor:
    return lm.embed(input_ids)


def lm_logits(cfg: TextConfig, lm: LanguageModel, hidden: torch.Tensor) -> torch.Tensor:
    """[T, D] -> [T, V] float32 logits: the f32 product of the (bf16)
    operands with no bf16 round, as the JAX package's
    preferred_element_type=float32. A W8A8 or W4A8 lm_head (tied
    embeddings: the quantized copy of embed) runs K5 or qdot4 with an f32
    output."""
    if isinstance(lm.lm_head, QUANTIZED_LINEARS):
        logits = lm.lm_head(hidden, out_dtype=torch.float32)
    else:
        w = lm.embed.weight if cfg.tie_word_embeddings else lm.lm_head.weight
        logits = f32_product(hidden, w)
    if lm.vocab_group is not None:  # a tensor-parallel head: each rank's vocab rows
        from ...parallel.distributed import all_gather

        logits = all_gather(logits, lm.vocab_group, logits.dim() - 1)
    return logits


def head_weight(cfg: TextConfig, lm: LanguageModel) -> torch.Tensor:
    """The [V, D] matrix of the CE head (a tied model's embedding): the
    whole matrix on every rank where it is sharded (parallel/tp.py)."""
    mod = lm.embed if cfg.tie_word_embeddings else lm.lm_head
    full = getattr(mod, "full_weight", None)
    return full() if full is not None else mod.weight


def init_kv_arena(
    cfg: TextConfig, capacity: int, dtype=torch.bfloat16, device=None, quant: str = "none",
    lead_dims: Tuple[int, ...] = (),
) -> Tuple[Arena, Arena]:
    """Allocate the zeroed [*lead_dims, L, C, Hkv, hd] K/V arenas (lead_dims
    (B,): the multi-stream engine's stacked lanes): float in `dtype`, or
    with quant="int8" QuantKV pairs (the quantization of zeros: q = 0,
    s = 1e-12), half the bytes."""
    shape = (*lead_dims, cfg.num_hidden_layers, capacity, cfg.num_key_value_heads, cfg.head_dim)
    if quant == "int8":  # built directly: no float transient of the arena's size

        def zeros():
            return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.full(shape[:-1], 1e-12, dtype=torch.float32, device=device))

        return zeros(), zeros()
    if quant != "none":
        raise ValueError(f"kv_quant must be 'none' or 'int8', got {quant!r}")
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )
