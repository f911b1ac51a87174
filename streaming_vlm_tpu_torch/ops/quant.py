"""int8 quantization: the KV arena (StreamConfig.kv_quant="int8") and W8A8
weights (kernel K5).

Port of streaming_vlm_tpu/ops/quant.py. The arithmetic is the JAX
package's, op for op, so that both give the same bits as its jitted
functions: s = max|x| * f32(1/127) clamped at 1e-12 (XLA's form of
max|x| / 127 under jit; see INV127), q = clip(round(x / s), -127, 127) with
round half to even (torch.round and jnp.round agree) and a true division
x / s.

KV arena: each [..., hd] row is stored as int8 with one f32 symmetric
absmax scale over head_dim; K is quantized un-rotated. An arena is either a
float [L, C, Hkv, hd] tensor or a QuantKV of the same leading shape. The
helpers below are the only code that tells the two apart; the model and
the engine go through them.

W8A8 weights: per-output-channel int8 weights (`quantize_weight`) held by
`QLinear`, which takes nn.Linear's place; its forward is `qdot`: per-token
dynamic int8 activations x int8 weights -> int32, rescaled by (sx * s).
`qdot` and `int8_gemm` run kernel K5 (csrc/int8_gemm.cu) on CUDA tensors
and their plain versions on CPU tensors; there is no other fallback.
`quantize_model` turns a float model into this layout; the embedding table
stays float for gathers and tied embeddings get a quantized lm_head copy.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ._kernels import check_cuda, lib, ptr, stream


# 1/127 in f32. The JAX package's W8A8 code runs under jit (quantize_weight
# is jitted; qdot runs inside the jitted model), where XLA folds a division
# by the constant 127 into a product with this reciprocal: the scales are
# max|x| * INV127, not max|x| / 127 (they differ in the last bit for ~4% of
# rows). K5 does the same.
INV127 = float(np.float32(1.0) / np.float32(127.0))


def _absmax_scale(xf: torch.Tensor) -> torch.Tensor:
    """max|x| * INV127 over the last axis (kept), clamped at 1e-12, f32."""
    return (xf.abs().amax(dim=-1, keepdim=True) * INV127).clamp_min(1e-12)


class QuantKV(NamedTuple):
    """An int8 arena (or slice of one): q int8 [..., hd], s f32 [...]."""

    q: torch.Tensor
    s: torch.Tensor


Arena = Union[torch.Tensor, QuantKV]


def quantize_kv(x: torch.Tensor) -> QuantKV:
    """[..., hd] float -> QuantKV with per-leading-index absmax scales.

    The JAX engine quantizes KV only under jit (the chunk step's arena merge,
    the jitted arena init), where XLA folds its `/ 127.0` into a product
    with f32(1/127): the scale is max|x| * INV127, as qdot's row scale, not
    a true division (the two differ in the last bit for ~4% of rows)."""
    xf = x.float()
    s = _absmax_scale(xf)
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return QuantKV(q, s[..., 0])


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


# ---------------------------------------------------------------------------
# W8A8 weights
# ---------------------------------------------------------------------------

# one count per wrapper call (int8_gemm or qdot) that launched kernel K5 (a
# qdot over more than the decode path's rows launches a row-quantize pass
# and the tiled product; it counts once)
launch_counts = {"int8_gemm": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a [out, in] weight
    (nn.Linear's layout; the JAX package's [in, out] with contract_axis=-2).
    Returns (q int8 [out, in], s f32 [out])."""
    wf = w.float()
    s = _absmax_scale(wf)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), s[:, 0].contiguous()


def int8_gemm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: int32 [M, N] = int8 [M, K] . int8 [N, K]^T,
    through float64 (exact: |acc| <= 127^2 K < 2^31 < 2^53; CUDA has no
    integer matmul)."""
    return (xq.double() @ wq.double().T).to(torch.int32)


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """K5: int32 [M, N] = int8 [M, K] . int8 [N, K]^T (the function of the
    TPU kernel `mm_kernel`; the weight in the [out, in] layout)."""
    if xq.device.type == "cpu":
        return int8_gemm_plain(xq, wq)
    name = "int8_gemm"
    check_cuda(name, xq, wq)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"{name}: takes int8 [M, K] and int8 [N, K]")
    (M, K), N = xq.shape, wq.shape[0]
    if wq.shape[1] != K or K % 4:
        raise ValueError(f"{name}: K must match and be a multiple of 4, got {tuple(xq.shape)} "
                         f"and {tuple(wq.shape)}")
    out = torch.empty(M, N, dtype=torch.int32, device=xq.device)
    err = lib().svt_int8_gemm(ptr(xq), ptr(wq), ptr(out), M, N, K, stream())
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """qdot's activation quantization of [M, K] rows: (xq int8 [M, K], sx
    f32 [M, 1])."""
    xf = x.float()
    sx = _absmax_scale(xf)
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def qdot_plain(x, q, s, bias=None, out_dtype=None) -> torch.Tensor:
    """Plain version of `qdot`, op for op the JAX package's: [..., K] x
    ([N, K] int8, [N] f32) -> [..., N] in out_dtype (default x's dtype),
    then + bias."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, sx = quantize_rows(x.reshape(-1, K))
    out = int8_gemm_plain(xq, q).float() * (sx * s)
    out = out.to(out_dtype or x.dtype).reshape(*lead, -1)
    return out if bias is None else out + bias


def qdot(x, q, s, bias=None, out_dtype=None) -> torch.Tensor:
    """Dynamic-activation W8A8 product through K5: the rows of x are
    quantized (per row), multiplied by the int8 weight in int32 and
    rescaled; + bias. On a CPU tensor, `qdot_plain`."""
    if x.device.type == "cpu":
        return qdot_plain(x, q, s, bias, out_dtype)
    name = "int8_gemm"
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M, N = x2.shape[0], q.shape[0]
    tensors = [x2, q, s] + ([] if bias is None else [bias])
    check_cuda(name, *tensors)
    floats = (torch.bfloat16, torch.float32)
    if x2.dtype not in floats or out_dtype not in floats:
        raise ValueError(f"{name}: x and the output must be bf16 or f32")
    if q.dtype != torch.int8 or q.shape != (N, K) or s.dtype != torch.float32 or s.shape != (N,):
        raise ValueError(f"{name}: the weight must be int8 [N, {K}] with f32 scales [N]")
    if K % 4 or M == 0:
        raise ValueError(f"{name}: K must be a multiple of 4 and M >= 1, got {tuple(x.shape)}")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (N,)):
        raise ValueError(f"{name}: the bias must be [N] in the output dtype")
    so = lib()
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    xq = sx = None
    if M > so.int8_small_m:  # scratch of the row-quantize pass
        xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
        sx = torch.empty(M, dtype=torch.float32, device=x.device)
    err = so.svt_qdot(
        ptr(x2), int(x2.dtype == torch.bfloat16), ptr(q), ptr(s), ptr(bias), ptr(out),
        int(out_dtype == torch.bfloat16), ptr(xq), ptr(sx), M, N, K, stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out.reshape(*lead, N)


class QLinear(nn.Module):
    """nn.Linear's W8A8 counterpart: int8 q [out, in] (contiguous: the
    layout both paths of K5 read), f32 per-output-channel scales s [out],
    and the bias in the model's dtype. forward(x, out_dtype) is `qdot`;
    the bias is added after the cast to the output dtype, as the JAX
    package's `mm(x, w) + b`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("q", torch.empty(out_features, in_features, dtype=torch.int8,
                                              device=device))
        self.register_buffer("s", torch.empty(out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "QLinear":
        w = lin.weight
        m = cls(w.shape[1], w.shape[0], lin.bias is not None, device=w.device, dtype=w.dtype)
        m.q, m.s = quantize_weight(w)
        if lin.bias is not None:
            m.bias.copy_(lin.bias)
        return m

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return qdot(x, self.q, self.s, self.bias, out_dtype)


# the port's modules that the JAX package's quantize_*_params turn into
# {"q", "s"} leaves (its LAYER_WEIGHTS, VISION_BLOCK_WEIGHTS, ...)
LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
VISION_BLOCK_LINEARS = ("qkv", "proj", "gate_proj", "up_proj", "down_proj")
VISION_MERGER_LINEARS = ("merger_fc1", "merger_fc2")


def is_qtensor(w) -> bool:
    """A quantized weight: a QLinear, or a JAX-layout {"q", "s"} (or int4
    {"q4", "s"}) mapping as models/bridge.py reads it."""
    if isinstance(w, QLinear):
        return True
    return isinstance(w, Mapping) and ("q" in w or "q4" in w) and "s" in w


def is_model_quantized(model) -> bool:
    """True when a model (nn.Module) or a JAX-layout parameter tree already
    holds quantized weights: callers that quantize on load skip their own
    pass."""
    if isinstance(model, nn.Module):
        return any(isinstance(m, QLinear) for m in model.modules())
    if is_qtensor(model):
        return True
    if isinstance(model, Mapping):
        return any(is_model_quantized(v) for v in model.values())
    if isinstance(model, (list, tuple)):
        return any(is_model_quantized(v) for v in model)
    return False


def _swap(parent: nn.Module, name: str) -> None:
    lin = getattr(parent, name)
    if not isinstance(lin, QLinear):
        setattr(parent, name, QLinear.from_linear(lin))


@torch.no_grad()
def quantize_language(lm: nn.Module) -> nn.Module:
    """Quantize the decoder-layer projections and the lm_head of a
    models/qwen25_vl/language.LanguageModel in place. The embedding table,
    biases and norms keep their dtype; tied embeddings get a separate
    quantized lm_head (the JAX package's "lm_head_q")."""
    for layer in lm.layers:
        for name in LAYER_LINEARS:
            _swap(layer, name)
    if lm.lm_head is None:  # tied: quantize embed (already [V, D] = [out, in])
        w = lm.embed.weight
        head = QLinear(w.shape[1], w.shape[0], bias=False, device=w.device, dtype=w.dtype)
        head.q, head.s = quantize_weight(w)
        lm.lm_head = head
    else:
        _swap(lm, "lm_head")
    return lm


@torch.no_grad()
def quantize_vision(tower: nn.Module) -> nn.Module:
    """Quantize the ViT block and merger projections of a
    models/qwen25_vl/vision.VisionTower in place; the patch embedding stays
    float (its input is raw normalised pixels)."""
    for blk in tower.blocks:
        for name in VISION_BLOCK_LINEARS:
            _swap(blk, name)
    for name in VISION_MERGER_LINEARS:
        _swap(tower, name)
    return tower


def quantize_model(model: nn.Module, bits: int = 8) -> nn.Module:
    """W8A8 for a full model (vision tower + language model), in place."""
    if bits != 8:
        raise NotImplementedError(
            f"bits={bits}: only int8 weights are ported (W4A8, the JAX package's qdot4, is not)"
        )
    quantize_vision(model.vision)
    quantize_language(model.text)
    return model
