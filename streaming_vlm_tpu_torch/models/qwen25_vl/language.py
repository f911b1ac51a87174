"""Qwen2.5-VL language model (decoder stack) in PyTorch.

Port of streaming_vlm_tpu/models/qwen25_vl/language.py. Layers are an
`nn.ModuleList` walked by a Python loop (the JAX package scans stacked
weights). Weights are stored as `nn.Linear` ([out, in]); the bridge in
models/bridge.py transposes the JAX [in, out] layout.

The KV arena is a pair of [L, C, Hkv, hd] tensors holding UN-rotated K.
`language_forward_streaming` reads it and returns the block's new K/V as
[L, T, Hkv, hd] for the caller to merge:

* prefill mode (no `extra`) runs kernel K1 (`streaming_prefill_attention`)
  over the arena (pre-rotated, or raw and rotated in the kernel) plus the
  block's own causal keys;
* decode mode (`extra` = the rotated decode delta, T == 1) runs kernel K2
  (`streaming_decode_attention_full`) over the pre-rotated arena, the
  delta and the token itself.

On CPU tensors both kernels' wrappers run their plain versions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...config import TextConfig
from ...ops.attention import (
    gqa_attention_multi,
    streaming_decode_attention_full,
    streaming_prefill_attention,
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


def swiglu(x: torch.Tensor, gate: nn.Linear, up: nn.Linear, down: nn.Linear) -> torch.Tensor:
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


def _layer_body(
    cfg: TextConfig,
    hidden: torch.Tensor,
    layer: DecoderLayer,
    *,
    q_cos,
    q_sin,
    self_mask=None,  # [T, T] mask over the block's own keys (plain attention)
    decode=None,  # (ak, av, ek, ev, visible_len, extra_visible): T == 1 through
    # K2 over the pre-rotated arena, the rotated decode delta and the token
):
    """One decoder layer over the block's own K/V (plain attention under
    self_mask), or, in decode mode, over arena + delta + self through K2.
    Returns (hidden, k_new, k_new_rot, v_new)."""
    H, hd = cfg.num_attention_heads, cfg.head_dim
    q, k_new, k_new_rot, v_new = _qkv(cfg, hidden, layer, q_cos, q_sin)
    if decode is not None:
        ak, av, ek, ev, vis, evis = decode
        out = streaming_decode_attention_full(
            q[0], ak, av, torch.cat([ek, k_new_rot], dim=0),
            torch.cat([ev, v_new], dim=0), vis, evis, e_delta=ek.shape[0],
        )
        attn = out.reshape(1, H * hd)
    else:
        attn = gqa_attention_multi(q, [(k_new_rot, v_new, self_mask)])
    return _layer_tail(layer, hidden, attn), k_new, k_new_rot, v_new


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
        hidden, _, _, _ = _layer_body(
            cfg, hidden, layer, q_cos=q_cos, q_sin=q_sin, self_mask=attn_mask
        )
    return lm.final_ln(hidden)


def language_forward_streaming(
    cfg: TextConfig,
    lm: LanguageModel,
    inputs_embeds: torch.Tensor,  # [T, D]
    q_positions: torch.Tensor,  # [3, T] float32
    *,
    arena: Tuple[torch.Tensor, torch.Tensor],  # READ-ONLY [L, C, Hkv, hd] x2
    arena_positions: Optional[torch.Tensor] = None,  # [3, C] (raw-K arena)
    visible_len: int,  # arena slots < visible_len are attendable
    arena_rotated: bool = False,  # arena K already rotated for these positions
    extra: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [L, E, Hkv, hd] x2
    extra_visible: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Streaming decoder stack over a read-only KV arena. Returns (hidden
    [T, D] post-final-norm, (k_block, k_block_rot, v_block) each [L, T, Hkv,
    hd]).

    Prefill mode (no `extra`): K1 over the arena (pre-rotated, or raw and
    rotated in the kernel from `arena_positions`) + the causal block.
    Decode mode: `extra` is the ROTATED decode delta with rows <
    `extra_visible` visible, T == 1 and the arena pre-rotated; K2."""
    T = inputs_embeds.shape[0]
    H, hd = cfg.num_attention_heads, cfg.head_dim
    inv_freq = lm.inv_freq(inputs_embeds.device)
    q_cos, q_sin = mrope_cos_sin(q_positions, inv_freq, cfg.mrope_section)
    outs: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
    hidden = inputs_embeds
    if extra is None:
        acos2 = asin2 = None
        if not arena_rotated:
            a_cos, a_sin = mrope_cos_sin(arena_positions, inv_freq, cfg.mrope_section)
            acos2 = torch.cat([a_cos, a_cos], dim=-1).contiguous()
            asin2 = torch.cat([a_sin, a_sin], dim=-1).contiguous()
        for l, layer in enumerate(lm.layers):
            q, k_new, k_new_rot, v_new = _qkv(cfg, hidden, layer, q_cos, q_sin)
            attn = streaming_prefill_attention(
                q, arena[0][l], arena[1][l], acos2, asin2, k_new_rot, v_new, visible_len
            ).reshape(T, H * hd)
            hidden = _layer_tail(layer, hidden, attn)
            outs.append((k_new, k_new_rot, v_new))
    else:
        if T != 1 or not arena_rotated:
            raise ValueError("decode mode takes one token over a pre-rotated arena")
        for l, layer in enumerate(lm.layers):
            hidden, k_new, k_new_rot, v_new = _layer_body(
                cfg, hidden, layer, q_cos=q_cos, q_sin=q_sin,
                decode=(arena[0][l], arena[1][l], extra[0][l], extra[1][l],
                        visible_len, extra_visible),
            )
            outs.append((k_new, k_new_rot, v_new))
    k_block, k_block_rot, v_block = (torch.stack(x) for x in zip(*outs))
    return lm.final_ln(hidden), (k_block, k_block_rot, v_block)


def embed_tokens(cfg: TextConfig, lm: LanguageModel, input_ids: torch.Tensor) -> torch.Tensor:
    return lm.embed(input_ids)


def lm_logits(cfg: TextConfig, lm: LanguageModel, hidden: torch.Tensor) -> torch.Tensor:
    """[T, D] -> [T, V] float32 logits. The product runs in the weights'
    dtype (bf16 on the card, so the logits carry bf16 rounding; the JAX
    package accumulates to f32 output)."""
    w = lm.embed.weight if cfg.tie_word_embeddings else lm.lm_head.weight
    return F.linear(hidden, w).float()


def init_kv_arena(
    cfg: TextConfig, capacity: int, dtype=torch.bfloat16, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the zeroed [L, C, Hkv, hd] K/V arenas (float arena only)."""
    shape = (cfg.num_hidden_layers, capacity, cfg.num_key_value_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def arena_capacity(arena: torch.Tensor) -> int:
    return arena.shape[1]
