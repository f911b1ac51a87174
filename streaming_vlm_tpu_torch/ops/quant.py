"""int8 KV-arena quantization (StreamConfig.kv_quant="int8").

Port of `quantize_kv`, `dequantize_kv` and `is_kv_quantized` of the JAX
package's streaming_vlm_tpu/ops/quant.py, as plain elementwise PyTorch (they
are plain XLA there). Each [..., hd] row is stored as int8 with one f32
symmetric absmax scale over head_dim; K is quantized un-rotated. The
arithmetic is the JAX package's, op for op, so that both give the same bits:
s = max|x| / 127 clamped at 1e-12, q = clip(round(x / s), -127, 127) with
round half to even (torch.round and jnp.round agree) and a true division.

An arena is either a float [L, C, Hkv, hd] tensor or a QuantKV of the same
leading shape. The helpers below are the only code that tells the two
apart; the model and the engine go through them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch


class QuantKV(NamedTuple):
    """An int8 arena (or slice of one): q int8 [..., hd], s f32 [...]."""

    q: torch.Tensor
    s: torch.Tensor


Arena = Union[torch.Tensor, QuantKV]


def quantize_kv(x: torch.Tensor) -> QuantKV:
    """[..., hd] float -> QuantKV with per-leading-index absmax scales."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return QuantKV(q, s)


def dequantize_kv(t: QuantKV, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (t.q.float() * t.s[..., None]).to(dtype)


def is_kv_quantized(t) -> bool:
    return isinstance(t, QuantKV)


def arena_capacity(arena: Arena) -> int:
    """Slot count (axis 1 of [L, C, Hkv, hd]) in either representation."""
    return storage(arena)[0].shape[1]


def layer_slice(arena: Arena, l: int) -> Arena:
    """Layer l's [C, Hkv, hd] slice, in the arena's representation."""
    return QuantKV(arena.q[l], arena.s[l]) if is_kv_quantized(arena) else arena[l]


def gather_slots(arena: Arena, src_idx: torch.Tensor) -> Arena:
    """new[:, i] = old[:, src_idx[i]], gathered into fresh tensors."""
    if is_kv_quantized(arena):
        return QuantKV(arena.q.index_select(1, src_idx), arena.s.index_select(1, src_idx))
    return arena.index_select(1, src_idx)


def write_slots(arena: Arena, block: torch.Tensor, at: int) -> None:
    """Write a [L, T, Hkv, hd] float block into slots [at, at + T), in place,
    in the arena's representation (quantized per slot into an int8 arena)."""
    T, C = block.shape[1], arena_capacity(arena)
    if not (0 <= at and at + T <= C):
        raise ValueError(f"block [{at}, {at + T}) outside the arena's {C} slots")
    if is_kv_quantized(arena):
        qb = quantize_kv(block)
        arena.q[:, at : at + T] = qb.q
        arena.s[:, at : at + T] = qb.s
    else:
        arena[:, at : at + T] = block.to(arena.dtype)


def as_float(arena: Arena, dtype: torch.dtype) -> torch.Tensor:
    """The arena (or a slice) in `dtype`: dequantized, or a float arena as
    it is (no copy)."""
    return dequantize_kv(arena, dtype) if is_kv_quantized(arena) else arena


def storage(arena: Arena) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scales): int8 data with its f32 scales, or a float arena and
    None; the form that kernel K3 reads."""
    return (arena.q, arena.s) if is_kv_quantized(arena) else (arena, None)


def compute_dtype(arena: Arena, default: torch.dtype) -> torch.dtype:
    """The float dtype of a float arena; `default` for an int8 one, which
    carries none."""
    return default if is_kv_quantized(arena) else arena.dtype
