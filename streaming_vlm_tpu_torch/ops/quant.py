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

W4A8 weights (`quantize_model(bits=4)`, the JAX package's
`quantize_model_params(text_bits=4)`): the decoder's projections and the
lm_head as symmetric int4 with one f32 scale per (128-row contract group,
output channel), two values packed per byte along the contract axis
(`quantize_weight_int4`), held by `QLinear4`. Its forward is `qdot4`: at
32 rows or more the weight is dequantized to bf16 and multiplied with f32
accumulation (torch.mm; the JAX package's XLA dot); below 32 rows kernel
K5-int4 (csrc/int4_gemv.cu) takes int8 rows x packed int4 weights to
per-group int32 sums and folds the groups in order, over a host-made plan
(`int4_plan`: how K is cut into slabs across CTAs). The vision tower stays
int8.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._kernels import check_cuda, check_rows, lib, ptr, sm_count, stream


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
    """Slot count (axis -3 of [L, C, Hkv, hd] or of the multi-stream [B, L,
    C, Hkv, hd]) in either representation."""
    return storage(arena)[0].shape[-3]


def lanes_layer(arena: Arena, l: int) -> Arena:
    """Layer l of a [B, L, C, Hkv, hd] arena: a [B, C, Hkv, hd] view whose
    lanes lie L layers apart, in the arena's representation."""
    if is_kv_quantized(arena):
        return QuantKV(arena.q[:, l], arena.s[:, l])
    return arena[:, l]


def lane(arena: Arena, b: int) -> Arena:
    """Lane b of a [B, ...] arena (a view), in the arena's representation."""
    return QuantKV(arena.q[b], arena.s[b]) if is_kv_quantized(arena) else arena[b]


def with_lanes(arena: Arena) -> Arena:
    """A one-stream [L, C, Hkv, hd] arena as a [1, L, C, Hkv, hd] view."""
    return QuantKV(arena.q[None], arena.s[None]) if is_kv_quantized(arena) else arena[None]


def gather_slots(arena: Arena, src_idx: torch.Tensor) -> Arena:
    """new[:, i] = old[:, src_idx[i]], gathered into fresh tensors."""
    if is_kv_quantized(arena):
        return QuantKV(arena.q.index_select(1, src_idx), arena.s.index_select(1, src_idx))
    return arena.index_select(1, src_idx)


def gather_slots_lanes(arena: Arena, src_idx: torch.Tensor) -> Arena:
    """new[b, :, i] = old[b, :, src_idx[b, i]] over a [B, L, C, ...] arena
    (either representation) and src_idx [B, C], into fresh tensors (one
    gather per leaf)."""

    def g(x):
        B, L = x.shape[:2]
        idx = src_idx.view(B, 1, -1, *([1] * (x.dim() - 3))).expand(B, L, -1, *x.shape[3:])
        return torch.gather(x, 2, idx)

    if is_kv_quantized(arena):
        return QuantKV(g(arena.q), g(arena.s))
    return g(arena)


def write_slots_lanes(arena: Arena, block: torch.Tensor, at) -> None:
    """Write lane b's [L, T, Hkv, hd] float block of block [B, L, T, Hkv,
    hd] into its slots [at[b], at[b] + T) of a [B, L, C, ...] arena, in
    place, in the arena's representation (an int8 arena's block is
    quantized once, for all lanes)."""
    q = quantize_kv(block) if is_kv_quantized(arena) else None
    for b, a in enumerate(at):
        if q is None:
            write_slots(lane(arena, b), block[b], int(a))
        else:
            _check_slots(arena, block.shape[2], int(a))
            arena.q[b, :, a : a + block.shape[2]] = q.q[b]
            arena.s[b, :, a : a + block.shape[2]] = q.s[b]


def _check_slots(arena: Arena, T: int, at: int) -> None:
    C = arena_capacity(arena)
    if not (0 <= at and at + T <= C):
        raise ValueError(f"block [{at}, {at + T}) outside the arena's {C} slots")


def write_slots(arena: Arena, block: torch.Tensor, at: int) -> None:
    """Write a [L, T, Hkv, hd] float block into slots [at, at + T), in place,
    in the arena's representation (quantized per slot into an int8 arena)."""
    T = block.shape[1]
    _check_slots(arena, T, at)
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
# and the tiled product; it counts once), and the same calls by path: the
# decode GEMV (M <= the library's int8_small_m) or the tiled product
launch_counts = {"int8_gemm": 0}
path_counts = {"gemv": 0, "tiled": 0, "int4": 0}  # int4: K5-int4's launches (qdot4)


def reset_launch_counts() -> None:
    for counts in (launch_counts, path_counts):
        for k in counts:
            counts[k] = 0


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


# ---- K5's tiled path: tile shape and schedule (made on the host) ----------

GEMM_BM = 128  # rows of an output tile (csrc/int8_gemm.cu BM)
GEMM_BK = 128  # bytes of K per K block (BK)
GEMM_BNS = (256, 128)  # the tile widths the kernel is built for, preferred first
ROW_ALIGN = 16  # TMA's row-stride rule: K5's tiled operands have rows 16-byte multiples apart


def padded_k(K: int) -> int:
    """K rounded up to a multiple of ROW_ALIGN: the row length, in bytes, of
    an int8 operand that the tiled path reads through a tensor map."""
    return -(-int(K) // ROW_ALIGN) * ROW_ALIGN


class GemmPlan(NamedTuple):
    """Which CTA of K5's tiled path runs which work. A unit is one K block of
    one output tile; tiles are numbered m-fastest (tile t is m tile t % mt,
    n tile t // mt, so CTAs that run at once share weight tiles). Whole tiles
    are dealt round-robin in full waves; the rest of the units, in (tile, K
    block) order, are cut into one contiguous, equal (to one unit) share per
    CTA. A share's run within one tile is a segment. `gemm_plan` picks the
    tile width and how far a tile's K loop may be split."""

    bn: int  # tile width
    segs: np.ndarray  # int32 [n_segs, 6]: m tile, n tile, first K block, end K block,
    # partial slot, fixup (-1, -1: the segment covers the tile's whole K loop)
    cta_segs: np.ndarray  # int32 [n_ctas + 1]: CTA c runs segs[cta_segs[c] : cta_segs[c + 1]]
    fixups: np.ndarray  # int32 [n_fixups, 2]: first partial slot, count (one per split tile)
    n_slots: int

    @property
    def n_ctas(self) -> int:
        return len(self.cta_segs) - 1


def stream_k_plan(M: int, N: int, K: int, n_sms: int, bn: int, max_split: int) -> GemmPlan:
    """K5's tiled schedule for tile width bn over min(n_sms, tiles *
    max_split, units) persistent CTAs. Full waves of whole tiles first, as
    long as at least one full wave of tiles is left over; those leftover
    tiles are split into equal shares of K blocks (stream-K), so that no CTA
    idles in a partial last wave. A tile whose K blocks two or more CTAs
    share gets a partial slot per segment and one fixup; the int32 partials
    add up exactly. max_split = 0: whole tiles only, dealt round-robin over
    min(n_sms, tiles) CTAs (the last wave may be partial)."""
    mt, nt, kb = -(-M // GEMM_BM), -(-N // bn), -(-K // GEMM_BK)
    tiles = mt * nt
    n_ctas = min(int(n_sms), tiles * max(max_split, 1), tiles * kb)
    waves = -(-tiles // n_ctas) if max_split == 0 else max(tiles // n_ctas - 1, 0)
    n_dp = min(waves * n_ctas, tiles)
    units = (tiles - n_dp) * kb
    bounds = np.arange(n_ctas + 1) * units // n_ctas
    segs, cta_segs = [], [0]
    for c in range(n_ctas):
        for t in range(c, min(waves * n_ctas, tiles), n_ctas):
            segs.append([t % mt, t // mt, 0, kb, -1, -1])
        u, hi = int(bounds[c]), int(bounds[c + 1])
        while u < hi:
            t, k0 = n_dp + u // kb, u % kb
            k1 = min(kb, k0 + hi - u)
            split = k0 > 0 or k1 < kb
            segs.append([t % mt, t // mt, k0, k1, 0 if split else -1, -1])
            u += k1 - k0
        cta_segs.append(len(segs))
    segs = np.array(segs, np.int32).reshape(-1, 6)
    split = np.flatnonzero(segs[:, 4] == 0)
    segs[split, 4] = np.arange(len(split))
    fixups = []  # a split tile's segments are consecutive in CTA order, so are its slots
    for j, i in enumerate(split):
        if j and (segs[split[j - 1], :2] == segs[i, :2]).all():
            fixups[-1][1] += 1
        else:
            fixups.append([int(segs[i, 4]), 1])
        segs[i, 5] = len(fixups) - 1
    plan = GemmPlan(bn, segs, np.array(cta_segs, np.int32),
                    np.array(fixups, np.int32).reshape(-1, 2), len(split))
    for a in plan[1:4]:
        a.setflags(write=False)
    return plan


# The cost model that picks a plan, fitted to device times of the int32
# form on an H100 (chip_smoke.py phase 3; PERF.md): a tile costs a fixed
# TILE_S (ring fill and epilogue) plus UNIT_S per K block, by tile width;
# a partial tile is written, and a fixup's partials read back, at
# SM_L2_BYTES_PER_S for one SM. Splitting a tile's K loop (stream-K) is
# considered only while the weight fits in half of the 50 MB L2: CTAs at
# different K offsets of one weight tile do not share its reads, and a
# larger weight then streams from memory once per m tile (measured: 1.6x
# slower than whole tiles at 640 x 18944 x 3584).
TILE_S = 2e-6
UNIT_S = {256: 0.6e-6, 128: 0.33e-6}
SM_L2_BYTES_PER_S = 4.5e10
STREAM_K_MAX_WEIGHT_BYTES = 25 * 2**20
MAX_SPLITS = (1, 2, 4, 8, 16)


def plan_cost(plan: GemmPlan) -> float:
    """Estimated seconds of the busiest CTA: TILE_S per segment and UNIT_S
    per K block, plus its partial tiles written and, where it may be the
    last to arrive, the largest fixup's partials read back."""
    tile_bytes = 4 * GEMM_BM * plan.bn
    longest_fix = int(plan.fixups[:, 1].max()) if len(plan.fixups) else 0
    worst = 0.0
    for a, b in zip(plan.cta_segs[:-1], plan.cta_segs[1:]):
        seg = plan.segs[a:b]
        n_part = int((seg[:, 4] >= 0).sum())
        t = len(seg) * TILE_S + int((seg[:, 3] - seg[:, 2]).sum()) * UNIT_S[plan.bn]
        t += (n_part + (longest_fix if n_part else 0)) * tile_bytes / SM_L2_BYTES_PER_S
        worst = max(worst, t)
    return worst


def gemm_plan(M: int, N: int, K: int, n_sms: int) -> GemmPlan:
    """K5's tiled schedule for an [M, K] x [N, K] product: of whole-tile
    plans at each tile width (GEMM_BNS) and, for a weight of at most
    STREAM_K_MAX_WEIGHT_BYTES, stream-K plans with each cap on how many
    CTAs share a tile (MAX_SPLITS), the one with the least `plan_cost`; the
    first on a tie (wider tiles, whole tiles)."""
    splits = (0,) + (MAX_SPLITS if N * K <= STREAM_K_MAX_WEIGHT_BYTES else ())
    plans = [stream_k_plan(M, N, K, n_sms, bn, s) for bn in GEMM_BNS for s in splits]
    return min(plans, key=plan_cost)


@functools.lru_cache(maxsize=64)
def _gemm_plan_on(device: torch.device, M: int, N: int, K: int,
                  n_sms: int) -> Tuple[GemmPlan, torch.Tensor]:
    """The plan and its int32 copy on the device (segments, CTA offsets,
    fixups), cached: the layers of a chunk share a handful of shapes. The
    copy is staged in pinned memory and queued without a host sync."""
    plan = gemm_plan(M, N, K, n_sms)
    flat = np.concatenate([plan.segs.ravel(), plan.cta_segs, plan.fixups.ravel()])
    staged = torch.from_numpy(flat.astype(np.int32)).pin_memory()
    return plan, staged.to(device, non_blocking=True)


_gemm_scratch = {}  # device -> (int32 partials, int32 counters kept zero by the kernel)


def _gemm_workspace(device: torch.device, plan: GemmPlan):
    """The tiled path's partial tiles and fixup counters for `plan`, from a
    per-device cache that grows to the largest plan seen. The counters are
    zeroed once; the kernel's last arrival at each fixup resets its own.
    Calls on one stream run in order, so they share the cache."""
    parts = plan.n_slots * GEMM_BM * plan.bn
    counters = 2 * len(plan.fixups)
    have = _gemm_scratch.get(device)
    if have is None or have[0].numel() < parts or have[1].numel() < counters:
        old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.empty(max(parts, old[0], 1), dtype=torch.int32, device=device),
                torch.zeros(max(counters, old[1], 1), dtype=torch.int32, device=device))
        _gemm_scratch[device] = have
    return have


def _tiled_args(so, device, M: int, N: int, K: int):
    """(plan on the device, n_ctas, n_segs, bn, partials, counters): the
    tiled path's launch arguments, or Nones for the decode path."""
    if M <= so.int8_small_m:
        return None, 0, 0, 0, None, None
    if so.int8_block != (GEMM_BM, GEMM_BK):
        raise RuntimeError(f"int8_gemm: the library's tile {so.int8_block} is not the plan's")
    plan, plan_dev = _gemm_plan_on(device, M, N, K, sm_count(device))
    part, counters = _gemm_workspace(device, plan)
    return plan_dev, plan.n_ctas, len(plan.segs), plan.bn, part, counters


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    """A [rows, K] int8 matrix as a [rows, K] view of a [rows, padded_k(K)]
    buffer with zero padding: t itself when its rows are already a multiple
    of ROW_ALIGN bytes apart, else a copy."""
    K = t.shape[1]
    if t.stride(1) == 1 and t.stride(0) % ROW_ALIGN == 0 and t.data_ptr() % ROW_ALIGN == 0:
        return t
    buf = torch.zeros(t.shape[0], padded_k(K), dtype=t.dtype, device=t.device)
    buf[:, :K] = t
    return buf[:, :K]


def _count(path: str) -> None:
    launch_counts["int8_gemm"] += 1
    path_counts[path] += 1


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """K5: int32 [M, N] = int8 [M, K] . int8 [N, K]^T (the function of the
    TPU kernel `mm_kernel`; the weight in the [out, in] layout). Either
    operand may be a [rows, K] view of padded rows. On the tiled path an
    operand whose rows are not 16-byte multiples apart is first copied into
    padded rows (`pad_rows`)."""
    if xq.device.type == "cpu":
        return int8_gemm_plain(xq, wq)
    name = "int8_gemm"
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"{name}: takes int8 [M, K] and int8 [N, K]")
    (M, K), N = xq.shape, wq.shape[0]
    if wq.shape[1] != K or K % 4:
        raise ValueError(f"{name}: K must match and be a multiple of 4, got {tuple(xq.shape)} "
                         f"and {tuple(wq.shape)}")
    check_rows(name, xq, K)
    check_rows(name, wq, K)
    so = lib()
    tiled = M > so.int8_small_m
    if tiled:
        xq, wq = pad_rows(xq), pad_rows(wq)
    plan, n_ctas, n_segs, bn, part, counters = _tiled_args(so, xq.device, M, N, K)
    out = torch.empty(M, N, dtype=torch.int32, device=xq.device)
    err = so.svt_int8_gemm(ptr(xq), xq.stride(0), ptr(wq), wq.stride(0), ptr(out), M, N, K,
                           ptr(plan), n_ctas, n_segs, bn, ptr(part), ptr(counters), stream())
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    _count("tiled" if tiled else "gemv")
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
    rescaled; + bias. q may be a [N, K] view of padded rows (QLinear's);
    on the tiled path a q whose rows are not 16-byte multiples apart is
    copied into padded rows first. On a CPU tensor, `qdot_plain`."""
    if x.device.type == "cpu":
        return qdot_plain(x, q, s, bias, out_dtype)
    name = "int8_gemm"
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M, N = x2.shape[0], q.shape[0]
    tensors = [x2, s] + ([] if bias is None else [bias])
    check_cuda(name, *tensors)
    floats = (torch.bfloat16, torch.float32)
    if x2.dtype not in floats or out_dtype not in floats:
        raise ValueError(f"{name}: x and the output must be bf16 or f32")
    if q.dtype != torch.int8 or q.shape != (N, K) or s.dtype != torch.float32 or s.shape != (N,):
        raise ValueError(f"{name}: the weight must be int8 [N, {K}] with f32 scales [N]")
    check_rows(name, q, K)
    if K % 4 or M == 0:
        raise ValueError(f"{name}: K must be a multiple of 4 and M >= 1, got {tuple(x.shape)}")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (N,)):
        raise ValueError(f"{name}: the bias must be [N] in the output dtype")
    so = lib()
    tiled = M > so.int8_small_m
    xq = sx = None
    if tiled:  # scratch of the row-quantize pass, rows padded for the tensor map
        q = pad_rows(q)
        xq = torch.empty(M, padded_k(K), dtype=torch.int8, device=x.device)
        sx = torch.empty(M, dtype=torch.float32, device=x.device)
    plan, n_ctas, n_segs, bn, part, counters = _tiled_args(so, x.device, M, N, K)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    err = so.svt_qdot(
        ptr(x2), int(x2.dtype == torch.bfloat16), ptr(q), q.stride(0), ptr(s), ptr(bias),
        ptr(out), int(out_dtype == torch.bfloat16), ptr(xq), padded_k(K), ptr(sx), M, N, K,
        ptr(plan), n_ctas, n_segs, bn, ptr(part), ptr(counters), stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    _count("tiled" if tiled else "gemv")
    return out.reshape(*lead, N)


class QLinear(nn.Module):
    """nn.Linear's W8A8 counterpart: int8 q [out, in], f32 per-output-channel
    scales s [out], and the bias in the model's dtype. forward(x, out_dtype)
    is `qdot`; the bias is added after the cast to the output dtype, as the
    JAX package's `mm(x, w) + b`.

    The int8 weight lives in the buffer `q_rows` [out, padded_k(in)], rows
    zero-padded to a multiple of 16 bytes (what K5's tiled path reads
    through a tensor map; vision down_proj has in = 3420); `q` is its [out,
    in] view, so reading, copying into and assigning `q` work as on a
    plain [out, in] tensor."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("q_rows", torch.zeros(out_features, padded_k(in_features),
                                                   dtype=torch.int8, device=device))
        self.register_buffer("s", torch.empty(out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @property
    def q(self) -> torch.Tensor:
        return self.q_rows[:, : self.in_features]

    @q.setter
    def q(self, value: torch.Tensor) -> None:
        if tuple(value.shape) != (self.out_features, self.in_features):
            raise ValueError(f"QLinear.q must be [{self.out_features}, {self.in_features}], "
                             f"got {tuple(value.shape)}")
        rows = torch.zeros(self.out_features, padded_k(self.in_features), dtype=torch.int8,
                           device=value.device)
        rows[:, : self.in_features] = value
        self.q_rows = rows

    def _apply(self, fn, recurse=True):
        # to_empty / .to(...) make fresh buffers (to_empty leaves them
        # uninitialised): keep the padding columns zero
        out = super()._apply(fn, recurse)
        if self.q_rows.shape[1] > self.in_features and self.q_rows.device.type != "meta":
            with torch.no_grad():
                self.q_rows[:, self.in_features:] = 0
        return out

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


# ---------------------------------------------------------------------------
# W4A8 weights
# ---------------------------------------------------------------------------

INT4_GROUP = 128  # contract rows per int4 scale group
INT4_MAX_ROWS = 31  # qdot4 runs K5-int4 below 32 rows (the JAX package's threshold)
# 1/7 in f32: the JAX package's int4 quantization runs jitted, where XLA
# folds max|w| / 7.0 into a product with this reciprocal (as with INV127)
INV7 = float(np.float32(1.0) / np.float32(7.0))


def int4_groups(D: int) -> int:
    """Scale groups along a contract axis of D rows: D // INT4_GROUP, or one
    group when INT4_GROUP does not divide D."""
    return D // INT4_GROUP if D % INT4_GROUP == 0 else 1


def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric group-wise int4 quantization of a [out, in] weight, the
    JAX package's `quantize_weight_int4` in the port's layout: s = max|w|
    over each group of INT4_GROUP contract rows (one group when that does
    not divide `in`) * f32(1/7), clamped at 1e-12; q = clip(round(w / s),
    -7, 7); contract rows 2d and 2d+1 of one output channel share byte d,
    2d in the low nibble. Returns (q4 int8 [out, in/2], s f32 [out, ng])."""
    out_f, D = w.shape
    if D % 2:
        raise ValueError(f"int4 weights need an even contract axis, got {D}")
    ng = int4_groups(D)
    wg = w.float().reshape(out_f, ng, D // ng)
    s = (wg.abs().amax(dim=-1, keepdim=True) * INV7).clamp_min(1e-12)
    q = torch.round(wg / s).clamp(-7, 7).to(torch.int8).reshape(out_f, D)
    packed = (q[:, 0::2] & 0xF) | (q[:, 1::2] << 4)
    return packed.contiguous(), s[..., 0].contiguous()


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """[out, in/2] packed int4 -> int8 [out, in]: each nibble sign-extended
    by two arithmetic shifts, as the JAX package's right_shift(left_shift(p,
    4), 4) (low) and right_shift(p, 4) (high)."""
    lo, hi = (q4 << 4) >> 4, q4 >> 4
    return torch.stack([lo, hi], dim=-1).reshape(q4.shape[0], -1)


def dequantize_int4(q4: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The [out, in] weight q * s (f32 products, one scale per group) in
    `dtype`: what qdot4 multiplies at 32 rows or more."""
    q = unpack_int4(q4)
    out_f, D = q.shape
    ng = s.shape[1]
    return (q.float().reshape(out_f, ng, D // ng) * s[:, :, None]).reshape(out_f, D).to(dtype)


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 [M, N] = x [M, K] . w [N, K]^T with f32 accumulation and no round
    of the result (the JAX package's preferred_element_type=float32):
    torch.mm with an f32 output for bf16 operands on the card, else the f32
    product of the operands' values (the CPU's torch.mm lacks out_dtype)."""
    if x.device.type == "cpu" or x.dtype == torch.float32 or w.dtype == torch.float32:
        return F.linear(x.float(), w.float())
    return torch.mm(x, w.t(), out_dtype=torch.float32)


def _qdot4_dense(x, q4, s, bias, out_dtype) -> torch.Tensor:
    """qdot4 at 32 rows or more: the weight dequantized to bf16, x rounded
    to bf16, their f32-accumulated product cast to out_dtype, + bias."""
    lead, K = x.shape[:-1], x.shape[-1]
    out = f32_product(x.reshape(-1, K).to(torch.bfloat16), dequantize_int4(q4, s))
    out = out.to(out_dtype or x.dtype).reshape(*lead, -1)
    return out if bias is None else out + bias


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors with one rounding, as a fused multiply-add:
    the product is exact in float64 (24 + 24 bits); the float64 sum is made
    round-to-odd (its exact error by TwoSum, then the odd neighbour where
    it was inexact), and a round-to-odd 53-bit value rounds to 24 bits as
    the exact one would."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def qdot4_plain(x, q4, s, bias=None, out_dtype=None) -> torch.Tensor:
    """Plain version of `qdot4`, op for op the JAX package's as jit runs
    it: [..., K] x ([N, K/2] packed int4, [N, ng] f32) -> [..., N] in
    out_dtype (default x's dtype), then + bias. Below 32 rows: x quantized
    per row (as qdot), int32 sums per scale group (exact, through float64),
    folded over the groups in order, fold = fma(f32(acc_g), s_g, fold) from
    0 (XLA contracts jnp.sum(acc * s, axis=0) into that chain), times sx;
    with one group, acc * (sx * s). In f32 the last product and + bias are
    one fused multiply-add, as jit fuses `mm(x, w) + b`; in bf16 the bias is
    added after the cast."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M, N, ng = x2.shape[0], q4.shape[0], s.shape[1]
    if M > INT4_MAX_ROWS:
        return _qdot4_dense(x, q4, s, bias, out_dtype)
    xq, sx = quantize_rows(x2)
    G = K // ng
    xg = xq.double().reshape(M, ng, G).transpose(0, 1)  # [ng, M, G]
    wg = unpack_int4(q4).double().reshape(N, ng, G).permute(1, 2, 0)  # [ng, G, N]
    acc = torch.bmm(xg, wg).float()  # [ng, M, N], exact: |acc| < 2^24
    if ng == 1:
        return _qdot4_out(acc[0], (sx * s[:, 0]).expand(M, N), bias, out_dtype or x.dtype, lead)
    a = torch.zeros(M, N, dtype=torch.float32, device=x.device)
    for g in range(ng):
        a = fma_f32(acc[g], s[:, g].expand(M, N), a)
    return _qdot4_out(a, sx.expand(M, N), bias, out_dtype or x.dtype, lead)


def _qdot4_out(a, b, bias, out_dtype, lead) -> torch.Tensor:
    """qdot4's epilogue below 32 rows: a * b in out_dtype, + bias; in f32 the
    product and + bias are one fused multiply-add, as jit fuses `mm(x, w) +
    b`; in bf16 the bias is added after the cast."""
    M, N = a.shape
    if bias is not None and out_dtype == torch.float32:
        return fma_f32(a, b, bias.expand(M, N)).reshape(*lead, N)
    out = (a * b).to(out_dtype).reshape(*lead, N)
    return out if bias is None else out + bias


# ---- K5-int4's plan: tiles, slabs and stages (made on the host) ------------

INT4_TILE_N = 16  # output channels of a warp's tile (csrc/int4_gemv.cu TILE_N)
INT4_WARPS = 8  # warps of a CTA (WARPS)
INT4_STAGE_GROUPS = 4  # 128-row groups of a ring stage (GS)
# a stage: the tile's packed bytes of 4 groups, then their scales (STAGE)
INT4_STAGE_BYTES = INT4_TILE_N * INT4_STAGE_GROUPS * (INT4_GROUP // 2 + 4)
INT4_MAX_STAGES = 16  # ring stages a warp may hold (MAX_STAGES)
INT4_STAGES = 4  # a warp's stages when every warp of its CTA is busy, where they fit
INT4_MIN_STAGES = 2  # fewer would not overlap copies with products: cut K into slabs instead
INT4_SMEM_CAP = 232448  # shared memory a block may take (SMEM_CAP)


class Int4Plan(NamedTuple):
    """Which CTA of K5-int4 runs which (16-channel tile, 128-row groups).
    K's nk = ceil(K / 128) groups are cut into `slabs` slabs of
    `slab_groups` groups (the last may be shorter); CTA b runs slab b %
    slabs, and warp w of it the tiles j + ctas * w + ctas * WARPS * i (j =
    b // slabs), i = 0, 1, ... (csrc/int4_gemv.cu). With one slab every
    warp folds its tiles whole; with more, each part leaves per-group
    records and the tile's last part folds them all in group order.
    `stages`: ring stages a warp."""

    slabs: int
    slab_groups: int
    ctas: int  # CTAs a slab
    stages: int

    @property
    def n_ctas(self) -> int:
        return self.slabs * self.ctas


def int4_row_tiles(M: int) -> int:
    """mma column tiles of 8 rows that K5-int4 runs for M rows (1, 2 or 4)."""
    return 1 if M <= 8 else 2 if M <= 16 else 4


def int4_smem_bytes(M: int, slab_groups: int, stages: int) -> int:
    """K5-int4's dynamic shared memory (csrc/int4_gemv.cu Layout): the warps'
    ring, the quantized rows of one slab, their group sums, row scales and
    maxima, the mbarriers, and 128 bytes to align the base."""
    mp = 8 * int4_row_tiles(M)
    return (INT4_WARPS * stages * INT4_STAGE_BYTES + M * INT4_GROUP * slab_groups
            + slab_groups * mp * 4 + 2 * mp * 4 + INT4_WARPS * INT4_MAX_STAGES * 8 + 128)


def _int4_slab_groups(nk: int, slabs: int) -> int:
    """Groups a slab when nk groups are cut into `slabs`: all of them for one
    slab, else ceil(nk / slabs) rounded up to whole stages."""
    if slabs == 1:
        return nk
    per_slab = -(-nk // slabs)
    return -(-per_slab // INT4_STAGE_GROUPS) * INT4_STAGE_GROUPS


def int4_plan(M: int, N: int, K: int, n_sms: int, slabs: Optional[int] = None) -> Int4Plan:
    """K5-int4's plan for an [M, K] x [N, K/2] product on n_sms SMs. Slabs:
    `slabs` when given, else as many as keep every warp of the card on at
    most one (tile, slab) part where the tiles alone are fewer than the
    warps (a warp's stages run one after another, so a long K on few tiles
    is a long chain: k/v, q/o and down_proj are cut, gate/up and the lm_head
    not), and in either case at least enough that the quantized rows leave
    room for INT4_MIN_STAGES stages a warp; rounded to whole stages; more
    than one needs scale groups (ng > 1). As many stages as fit, up to
    INT4_STAGES; one CTA a tile up to n_sms // slabs CTAs a slab."""
    nk = -(-K // INT4_GROUP)
    T = -(-N // INT4_TILE_N)

    def fits(gps: int, stages: int) -> bool:
        return int4_smem_bytes(M, gps, stages) <= INT4_SMEM_CAP

    if slabs is None:
        warps = n_sms * INT4_WARPS
        slabs = max(1, min(nk // INT4_STAGE_GROUPS, warps // T)) if int4_groups(K) > 1 else 1
    while slabs < nk and not fits(_int4_slab_groups(nk, slabs), INT4_MIN_STAGES):
        slabs += 1
    if slabs > 1 and int4_groups(K) == 1:
        raise ValueError(f"qdot4: K = {K} has one scale group; its K cannot be cut into slabs")
    gps = _int4_slab_groups(nk, min(slabs, nk))
    slabs = -(-nk // gps)
    stages = max((s for s in range(2, INT4_STAGES + 1) if fits(gps, s)), default=0)
    if not stages:
        raise ValueError(f"qdot4: {M} rows of a {gps}-group slab do not fit in shared memory")
    return Int4Plan(slabs, gps, max(1, min(n_sms // slabs, T)), stages)


@functools.lru_cache(maxsize=256)
def _int4_plan_on(M: int, N: int, K: int, n_sms: int, slabs: Optional[int]) -> Int4Plan:
    return int4_plan(M, N, K, n_sms, slabs)


_int4_scratch = {}  # device -> (f32 records, int32 counters kept zero by the kernel)
# (device, weight pointers, shapes, strides and dtypes, M, forced slabs) ->
# svt_qdot4's weight arguments and its shape, plan and scratch arguments:
# what a decode step's 197 calls would otherwise work out again each call
_int4_calls = {}
INT4_CALLS_MAX = 4096


def _int4_workspace(device: torch.device, plan: Int4Plan, M: int, N: int, K: int):
    """A split plan's records [T, nk, M + 1, 16] f32 and tile counters [T]
    from a per-device cache that grows to the largest plan seen (None, None
    for one slab). The counters are zeroed once; the tile's last part resets
    its own. Calls on one stream run in order, so they share the cache.
    Growing it drops the cached call arguments, which hold its pointers."""
    if plan.slabs == 1:
        return None, None
    T, nk = -(-N // INT4_TILE_N), -(-K // INT4_GROUP)
    recs = T * nk * (M + 1) * INT4_TILE_N
    have = _int4_scratch.get(device)
    if have is None or have[0].numel() < recs or have[1].numel() < T:
        old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.empty(max(recs, old[0]), dtype=torch.float32, device=device),
                torch.zeros(max(T, old[1]), dtype=torch.int32, device=device))
        _int4_scratch[device] = have
        _int4_calls.clear()
    return have


def _int4_weight_rows(name: str, t: torch.Tensor, shape, dtype, align: int,
                      device: torch.device) -> torch.Tensor:
    """A qdot4 weight operand (packed rows or their scales) on x's device
    with dense rows a multiple of `align` elements apart (16 bytes; what the
    kernel's tensor maps read): t itself when it is laid out so (QLinear4
    stores them so), else a padded copy."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: the weight must be packed int8 [N, K / 2] with f32 scales "
                         f"[N, ng] on x's device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(1) == 1 and t.stride(0) % align == 0 and t.data_ptr() % 16 == 0:
        return t
    rows = torch.zeros(shape[0], -(-shape[1] // align) * align, dtype=dtype, device=t.device)
    rows[:, : shape[1]] = t
    return rows[:, : shape[1]]


def _int4_args(name: str, device: torch.device, q4, s, M: int, N: int, K: int,
               slabs: Optional[int]):
    """svt_qdot4's arguments for this weight at M rows: (the weight and
    scales with their row strides), (shapes, plan, scratch) and the padded
    copies they point into (None where the weight is read in place: those
    arguments are cached per (weight, M, slabs))."""
    key = (device, q4.data_ptr(), s.data_ptr(), q4.shape, s.shape, q4.stride(), s.stride(),
           q4.dtype, s.dtype, M, slabs)
    args = _int4_calls.get(key)
    if args is not None:
        return args
    ng = int4_groups(K)
    rows = _int4_weight_rows(name, q4, (N, K // 2), torch.int8, ROW_ALIGN, device)
    srows = _int4_weight_rows(name, s, (N, ng), torch.float32, 4 if ng > 1 else 1, device)
    plan = _int4_plan_on(M, N, K, sm_count(device), slabs)
    scratch, counters = _int4_workspace(device, plan, M, N, K)
    args = ((ptr(rows), rows.stride(0), ptr(srows), srows.stride(0)),
            (M, N, K, ng, *plan, ptr(scratch), ptr(counters)), None)
    if rows is not q4 or srows is not s:
        return args[:2] + ((rows, srows),)
    if len(_int4_calls) >= INT4_CALLS_MAX:
        _int4_calls.clear()
    _int4_calls[key] = args
    return args


def qdot4(x, q4, s, bias=None, out_dtype=None) -> torch.Tensor:
    """Dynamic-activation W4A8 product, the JAX package's `qdot4` + bias:
    below 32 rows through kernel K5-int4 over `int4_plan` (x quantized per
    row in the kernel's prologue, packed nibbles unpacked into int8
    tensor-core products, int32 sums per group folded in group order,
    bitwise equal to `qdot4_plain` under every plan); at 32 rows or more the
    dequantized bf16 weight's f32-accumulated product. On a CPU tensor,
    `qdot4_plain`. The weight's packed rows and (ng > 1) its scales' rows
    must lie a multiple of 16 bytes apart for the kernel, as QLinear4 keeps
    them; other layouts are copied into such rows at every call."""
    return _qdot4_with_plan(x, q4, s, bias, out_dtype, None)


def _qdot4_with_plan(x, q4, s, bias=None, out_dtype=None, slabs: Optional[int] = None):
    """`qdot4` with K cut into `slabs` slabs by force (None: the planner's
    choice); the card's checks and tools reach every plan through it."""
    if x.device.type == "cpu":
        return qdot4_plain(x, q4, s, bias, out_dtype)
    name = "qdot4"
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M, N = x2.shape[0], q4.shape[0]
    if M > INT4_MAX_ROWS:
        return _qdot4_dense(x, q4, s, bias, out_dtype)
    so = lib()
    if so.int4_max_rows != INT4_MAX_ROWS:
        raise RuntimeError(f"{name}: the library takes {so.int4_max_rows} rows, not "
                           f"{INT4_MAX_ROWS}")
    check_cuda(name, *([x2] if bias is None else [x2, bias]))
    floats = (torch.bfloat16, torch.float32)
    if x2.dtype not in floats or out_dtype not in floats:
        raise ValueError(f"{name}: x and the output must be bf16 or f32")
    if K % 8 or M == 0:
        raise ValueError(f"{name}: K must be a multiple of 8 and M >= 1, got {tuple(x.shape)}")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (N,)):
        raise ValueError(f"{name}: the bias must be [N] in the output dtype")
    weight, dims, copies = _int4_args(name, x2.device, q4, s, M, N, K, slabs)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    err = so.svt_qdot4(ptr(x2), int(x2.dtype == torch.bfloat16), *weight, ptr(bias), ptr(out),
                       int(out_dtype == torch.bfloat16), *dims, stream())
    del copies  # padded copies (if any) live until their launch is queued
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    path_counts["int4"] += 1
    return out.reshape(*lead, N)


class QLinear4(nn.Module):
    """nn.Linear's W4A8 counterpart: packed int4 q4 [out, in/2] (int8
    storage, contract rows 2d / 2d+1 in the low / high nibble of byte d),
    f32 scales s [out, ng] (ng = in / INT4_GROUP, or 1), and the bias in the
    model's dtype. forward(x, out_dtype) is `qdot4`; the bias is added
    after the cast to the output dtype.

    The packed rows live in the buffer `q4_rows` [out, padded_k(in/2)] and
    the scales in `s_rows` [out, ng rounded up to 4 where ng > 1], rows
    zero-padded to multiples of 16 bytes (what K5-int4's tensor maps read
    in place); `q4` and `s` are their [out, in/2] and [out, ng] views, so
    reading, copying into and assigning them work as on plain tensors."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if in_features % 2:
            raise ValueError(f"int4 weights need an even in_features, got {in_features}")
        self.in_features, self.out_features = in_features, out_features
        self.ng = int4_groups(in_features)
        self.register_buffer("q4_rows", torch.zeros(out_features, padded_k(in_features // 2),
                                                    dtype=torch.int8, device=device))
        self.register_buffer("s_rows", torch.zeros(out_features, self._s_cols(),
                                                   dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    def _s_cols(self) -> int:
        return self.ng if self.ng == 1 else -(-self.ng // 4) * 4

    @property
    def q4(self) -> torch.Tensor:
        r, k = self.q4_rows, self.in_features // 2
        return r if r.shape[1] == k else r[:, :k]

    @q4.setter
    def q4(self, value: torch.Tensor) -> None:
        self.q4_rows = self._padded("q4", value, self.in_features // 2, self.q4_rows.shape[1])

    @property
    def s(self) -> torch.Tensor:
        r = self.s_rows
        return r if r.shape[1] == self.ng else r[:, : self.ng]

    @s.setter
    def s(self, value: torch.Tensor) -> None:
        self.s_rows = self._padded("s", value, self.ng, self._s_cols())

    def _padded(self, name: str, value: torch.Tensor, cols: int, width: int) -> torch.Tensor:
        if tuple(value.shape) != (self.out_features, cols):
            raise ValueError(f"QLinear4.{name} must be [{self.out_features}, {cols}], got "
                             f"{tuple(value.shape)}")
        rows = torch.zeros(self.out_features, width, dtype=value.dtype, device=value.device)
        rows[:, :cols] = value
        return rows

    def _apply(self, fn, recurse=True):
        # to_empty / .to(...) make fresh buffers (to_empty leaves them
        # uninitialised): keep the padding columns zero
        out = super()._apply(fn, recurse)
        with torch.no_grad():
            for r, cols in ((self.q4_rows, self.in_features // 2), (self.s_rows, self.ng)):
                if r.shape[1] > cols and r.device.type != "meta":
                    r[:, cols:] = 0
        return out

    @classmethod
    @torch.no_grad()
    def from_weight(cls, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> "QLinear4":
        m = cls(w.shape[1], w.shape[0], bias is not None, device=w.device, dtype=w.dtype)
        m.q4, m.s = quantize_weight_int4(w)
        if bias is not None:
            m.bias.copy_(bias)
        return m

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return qdot4(x, self.q4, self.s, self.bias, out_dtype)


QUANTIZED_LINEARS = (QLinear, QLinear4)


# the port's modules that the JAX package's quantize_*_params turn into
# {"q", "s"} leaves (its LAYER_WEIGHTS, VISION_BLOCK_WEIGHTS, ...)
LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the vision block's projections, both variants (qwen2_5: the SwiGLU three;
# qwen2: fc1, fc2); a block holds the ones of its variant
VISION_BLOCK_LINEARS = ("qkv", "proj", "gate_proj", "up_proj", "down_proj", "fc1", "fc2")
VISION_MERGER_LINEARS = ("merger_fc1", "merger_fc2")


def is_qtensor(w) -> bool:
    """A quantized weight: a QLinear or QLinear4, or a JAX-layout {"q", "s"}
    (or int4 {"q4", "s"}) mapping as models/bridge.py reads it."""
    if isinstance(w, QUANTIZED_LINEARS):
        return True
    return isinstance(w, Mapping) and ("q" in w or "q4" in w) and "s" in w


def is_model_quantized(model) -> bool:
    """True when a model (nn.Module) or a JAX-layout parameter tree already
    holds quantized weights: callers that quantize on load skip their own
    pass."""
    if isinstance(model, nn.Module):
        return any(isinstance(m, QUANTIZED_LINEARS) for m in model.modules())
    if is_qtensor(model):
        return True
    if isinstance(model, Mapping):
        return any(is_model_quantized(v) for v in model.values())
    if isinstance(model, (list, tuple)):
        return any(is_model_quantized(v) for v in model)
    return False


def _swap(parent: nn.Module, name: str, bits: int = 8) -> None:
    lin = getattr(parent, name)
    if isinstance(lin, QUANTIZED_LINEARS):
        return
    if bits == 4:
        setattr(parent, name, QLinear4.from_weight(lin.weight, lin.bias))
    else:
        setattr(parent, name, QLinear.from_linear(lin))


@torch.no_grad()
def quantize_language(lm: nn.Module, bits: int = 8) -> nn.Module:
    """Quantize the decoder-layer projections and the lm_head of a
    models/qwen25_vl/language.LanguageModel in place: int8 (QLinear) or,
    with bits=4, int4 (QLinear4). The embedding table, biases and norms keep
    their dtype; tied embeddings get a separate quantized lm_head (the JAX
    package's "lm_head_q")."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for layer in lm.layers:
        for name in LAYER_LINEARS:
            _swap(layer, name, bits)
    if lm.lm_head is None:  # tied: quantize embed (already [V, D] = [out, in])
        w = lm.embed.weight
        if bits == 4:
            lm.lm_head = QLinear4.from_weight(w)
        else:
            head = QLinear(w.shape[1], w.shape[0], bias=False, device=w.device, dtype=w.dtype)
            head.q, head.s = quantize_weight(w)
            lm.lm_head = head
    else:
        _swap(lm, "lm_head", bits)
    return lm


@torch.no_grad()
def quantize_vision(tower: nn.Module) -> nn.Module:
    """Quantize the ViT block and merger projections of a
    models/qwen25_vl/vision.VisionTower in place; the patch embedding stays
    float (its input is raw normalised pixels)."""
    for blk in tower.blocks:
        for name in VISION_BLOCK_LINEARS:
            if hasattr(blk, name):
                _swap(blk, name)
    for name in VISION_MERGER_LINEARS:
        _swap(tower, name)
    return tower


def quantize_model(model: nn.Module, bits: int = 8) -> nn.Module:
    """W8A8 (bits=8) or W4A8 (bits=4) for a full model, in place. The
    vision tower is int8 either way, as the JAX package's
    quantize_model_params(text_bits=4) keeps it."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    quantize_vision(model.vision)
    quantize_language(model.text, bits)
    return model
