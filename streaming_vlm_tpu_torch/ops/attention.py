"""Streaming attention: the port's two hand-written CUDA kernels, their plain
PyTorch versions, and the plain multi-source softmax they are held against.

* `streaming_prefill_attention` (K1, csrc/prefill_attention.cu) replaces
  streaming_vlm_tpu/ops/attention.py `streaming_prefill_attention`.
* `streaming_decode_attention_full` (K2, csrc/decode_attention.cu) replaces
  streaming_vlm_tpu/ops/attention.py `streaming_decode_attention_full`.

Each wrapper keeps the JAX function's layout ([T, H, hd] queries, [C, Hkv,
hd] arenas). On a CUDA tensor it checks what the kernel takes (bf16,
contiguous, head_dim 128), launches on the current stream, raises if the
launch was refused, and counts the launch in `launch_counts`. On a CPU
tensor it runs the plain version. There is no other fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from ..models.qwen25_vl.rope import rotate_half

NEG_INF = -1e30

# one count per wrapper call that launched its kernel (a K2 call launches a
# split pass and a combine pass; it counts once)
launch_counts = {"streaming_prefill_attention": 0, "streaming_decode_attention_full": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain multi-source attention (the jnp `_gqa_attention_multi`)
# ---------------------------------------------------------------------------


def gqa_attention_multi(
    q: torch.Tensor,  # [T, H, hd] rotated
    kv_parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    # (k [S_p, Hkv, hd] rotated, v [S_p, Hkv, hd], mask [T, S_p] bool)
) -> torch.Tensor:
    """GQA attention over several read-only KV sources with one joint
    softmax, in f32. Head h reads kv head h // G. Returns [T, H * hd] in
    v's dtype. Port of language.py `_gqa_attention_multi`."""
    T, H, hd = q.shape
    Hkv = kv_parts[0][0].shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(T, Hkv, G, hd)
    blocks = []
    for k, _, mask in kv_parts:
        lg = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
        blocks.append(lg.masked_fill(~mask[None, None], NEG_INF))
    m = blocks[0].amax(dim=-1, keepdim=True)
    for lg in blocks[1:]:
        m = torch.maximum(m, lg.amax(dim=-1, keepdim=True))
    denom = 0.0
    out = 0.0
    for lg, (_, v, _) in zip(blocks, kv_parts):
        e = torch.exp(lg - m)
        denom = denom + e.sum(dim=-1, keepdim=True)
        out = out + torch.einsum("kgts,skd->tkgd", e, v.float())
    out = out / denom.permute(2, 0, 1, 3)  # [T, Hkv, G, 1]
    return out.reshape(T, H * hd).to(kv_parts[0][1].dtype)


def _rotate_dup_half(k: torch.Tensor, cos2: torch.Tensor, sin2: torch.Tensor) -> torch.Tensor:
    """k * cos2 + rotate_half(k) * sin2 over [C, Hkv, hd] with per-slot
    duplicated-half tables [C, hd], in f32."""
    kf = k.float()
    return kf * cos2[:, None, :] + rotate_half(kf) * sin2[:, None, :]


# ---------------------------------------------------------------------------
# K1: chunk-prefill attention
# ---------------------------------------------------------------------------


def prefill_attention_plain(
    q_rot, k_arena, v_arena, acos2, asin2, k_self_rot, v_self, visible_len: int
) -> torch.Tensor:
    """Plain version of K1: f32 joint softmax over arena slots <
    visible_len (no causal mask; K rotated here from acos2/asin2 unless
    they are None) and the causal self block. Returns [T, H, hd] in v's
    dtype."""
    T, H, hd = q_rot.shape
    vis = int(visible_len)
    ka = k_arena[:vis]
    if acos2 is not None:
        ka = _rotate_dup_half(ka, acos2[:vis], asin2[:vis]).to(v_arena.dtype)
    causal = torch.ones(T, T, dtype=torch.bool, device=q_rot.device).tril()
    parts = [(k_self_rot, v_self, causal)]
    if vis:
        arena_mask = torch.ones(T, vis, dtype=torch.bool, device=q_rot.device)
        parts.insert(0, (ka, v_arena[:vis], arena_mask))
    return gqa_attention_multi(q_rot, parts).reshape(T, H, hd)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def streaming_prefill_attention(
    q_rot: torch.Tensor,  # [T, H, hd] rotated queries (unscaled)
    k_arena: torch.Tensor,  # [C, Hkv, hd] raw, or pre-rotated if acos2 is None
    v_arena: torch.Tensor,  # [C, Hkv, hd]
    acos2: Optional[torch.Tensor],  # [C, hd] f32 duplicated-half cos, or None
    asin2: Optional[torch.Tensor],
    k_self_rot: torch.Tensor,  # [T, Hkv, hd]
    v_self: torch.Tensor,  # [T, Hkv, hd]
    visible_len: int,
) -> torch.Tensor:
    """K1. Returns attention output [T, H, hd] in v's dtype."""
    if q_rot.device.type == "cpu":
        return prefill_attention_plain(
            q_rot, k_arena, v_arena, acos2, asin2, k_self_rot, v_self, visible_len
        )
    name = "streaming_prefill_attention"
    T, H, hd = q_rot.shape
    C, Hkv, _ = k_arena.shape
    tensors = [q_rot, k_arena, v_arena, k_self_rot, v_self]
    _check_cuda(name, *tensors)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    if hd != 128 or H % Hkv or v_arena.shape != k_arena.shape:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} arena={tuple(k_arena.shape)}")
    if k_self_rot.shape != (T, Hkv, hd) or v_self.shape != (T, Hkv, hd):
        raise ValueError(f"{name}: self block must be [T, Hkv, hd]")
    if not 0 <= int(visible_len) <= C:
        raise ValueError(f"{name}: visible_len {visible_len} outside [0, {C}]")
    if (acos2 is None) != (asin2 is None):
        raise ValueError(f"{name}: pass both acos2 and asin2, or neither")
    if acos2 is not None:
        _check_cuda(name, acos2, asin2)
        if acos2.dtype != torch.float32 or acos2.shape != (C, hd) or asin2.shape != (C, hd):
            raise ValueError(f"{name}: acos2/asin2 must be f32 [C, hd]")
    from ._kernels import lib

    out = torch.empty_like(q_rot)
    err = lib().svt_prefill_attention(
        _ptr(q_rot), _ptr(k_arena), _ptr(v_arena), _ptr(acos2), _ptr(asin2),
        _ptr(k_self_rot), _ptr(v_self), _ptr(out), T, H, Hkv, hd, int(visible_len),
        _stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# K2: decode attention over arena + decode delta + self
# ---------------------------------------------------------------------------


def decode_attention_plain(
    q_rot, k_arena, v_arena, k_small, v_small, visible_len: int,
    extra_visible: int, *, e_delta: int,
) -> torch.Tensor:
    """Plain version of K2: f32 joint softmax of one token over arena slots
    < visible_len, delta rows k_small[:e_delta] below extra_visible, and the
    always-visible self rows k_small[e_delta:]. Returns [H, hd] in
    v_small's dtype."""
    H, hd = q_rot.shape
    dev = q_rot.device
    vis = int(visible_len)
    e1 = k_small.shape[0]
    col = torch.arange(e1, device=dev)
    small_mask = ((col < int(extra_visible)) | (col >= e_delta))[None, :]
    parts = [(k_small, v_small, small_mask)]
    if vis:
        parts.insert(
            0, (k_arena[:vis], v_arena[:vis], torch.ones(1, vis, dtype=torch.bool, device=dev))
        )
    return gqa_attention_multi(q_rot[None], parts).reshape(H, hd).to(v_small.dtype)


def streaming_decode_attention_full(
    q_rot: torch.Tensor,  # [H, hd] rotated single-token queries (unscaled)
    k_arena: torch.Tensor,  # [C, Hkv, hd] pre-rotated arena K
    v_arena: torch.Tensor,
    k_small: torch.Tensor,  # [e_delta + 1, Hkv, hd] rotated delta rows ++ self row
    v_small: torch.Tensor,
    visible_len: int,
    extra_visible: int,
    *,
    e_delta: int,
) -> torch.Tensor:
    """K2. Returns [H, hd] in v_small's dtype.

    No-padding contract (as the TPU kernel's): k_small holds exactly
    e_delta delta rows followed by the self row(s), every one of which is
    visible; a padded k_small would let pad rows join the softmax."""
    E1 = k_small.shape[0]
    if E1 <= e_delta or v_small.shape != k_small.shape:
        raise ValueError(f"no-padding contract: k_small rows {E1} must exceed e_delta {e_delta}")
    if q_rot.device.type == "cpu":
        return decode_attention_plain(
            q_rot, k_arena, v_arena, k_small, v_small, visible_len, extra_visible,
            e_delta=e_delta,
        )
    name = "streaming_decode_attention_full"
    H, hd = q_rot.shape
    C, Hkv, _ = k_arena.shape
    tensors = [q_rot, k_arena, v_arena, k_small, v_small]
    _check_cuda(name, *tensors)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    from ._kernels import lib

    so = lib()
    if hd != 128 or H % Hkv or H // Hkv > 8 or v_arena.shape != k_arena.shape:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} arena={tuple(k_arena.shape)}")
    if k_small.shape[1:] != (Hkv, hd) or E1 > so.decode_max_small_rows:
        raise ValueError(f"{name}: k_small must be [<= {so.decode_max_small_rows}, Hkv, hd]")
    if not 0 <= int(visible_len) <= C or not 0 <= int(extra_visible) <= e_delta:
        raise ValueError(f"{name}: visible_len {visible_len} / extra_visible {extra_visible} out of range")
    G = H // Hkv
    n_splits = -(-int(visible_len) // so.decode_split_size)
    part_m = torch.empty(Hkv, n_splits, G, dtype=torch.float32, device=q_rot.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(Hkv, n_splits, G, hd, dtype=torch.float32, device=q_rot.device)
    out = torch.empty(H, hd, dtype=v_small.dtype, device=q_rot.device)
    err = so.svt_decode_attention(
        _ptr(q_rot), _ptr(k_arena), _ptr(v_arena), _ptr(k_small), _ptr(v_small),
        _ptr(part_m), _ptr(part_l), _ptr(part_acc), _ptr(out), H, Hkv, hd, E1,
        int(e_delta), int(visible_len), int(extra_visible), _stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out
