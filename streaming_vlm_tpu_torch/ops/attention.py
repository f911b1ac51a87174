"""Streaming and training attention: the port's hand-written CUDA kernels, their
plain PyTorch versions, and the plain multi-source softmax they are held
against. Each replaces the function of the same name in the JAX package's
streaming_vlm_tpu/ops/attention.py:

* `streaming_prefill_attention` (K1, csrc/prefill_attention.cu): chunk
  prefill over the arena (pre-rotated, or raw and rotated once per call by
  the kernel's rotate pass), run by persistent CTAs over `prefill_plan`.
* `streaming_decode_attention_full` (K2, csrc/decode_attention.cu): one
  token over the pre-rotated arena + decode delta + self, split by the
  host (`decode_split_size`) into parts that fill the card, the small
  block one more part, folded in the same launch
  (`decode_attention_by_splits` is its plain schedule).
* `streaming_decode_attention_int8` (K3, csrc/decode_attention_raw.cu): one
  token over the RAW arena in its storage form (int8 + scales, or bf16),
  dequantized and mRoPE-rotated in the kernel, + decode delta + self.
* `streaming_verify_attention` (K2-verify, csrc/verify_attention.cu): the
  T = k + 1 queries of a speculative-decoding verify round over the
  pre-rotated arena + decode delta + their own causal self rows, all T x G
  query rows of a kv head through the tensor cores over each split's rows
  staged once (split by `verify_split_size`; the JAX package computes this
  in XLA, `_gqa_attention_multi`); T == 1 is K2 itself.
* `train_attention` (training's causal self-attention, an autograd
  Function): K1 at visible 0 with each row's log-sum-exp in the forward,
  and `attention_bwd` (K1-bwd, csrc/attention_bwd.cu; the JAX package
  differentiates `_gqa_attention_chunked` by XLA's autodiff) in the
  backward.
* `streaming_decode_attention` (K4, csrc/decode_attention.cu): the arena's
  log2-space softmax partials of one token; `decode_attention_merge` folds
  them with the small parts (K2's independent cross-check, on no runtime
  path).

Each wrapper keeps the JAX function's layout ([T, H, hd] queries, [C, Hkv,
hd] arenas). On a CUDA tensor it checks what the kernel takes (bf16,
contiguous, head_dim 128), launches on the current stream, raises if the
launch was refused, and counts the launch in `launch_counts`. On a CPU
tensor it runs the plain version. There is no other fallback.

K1, K2 and K3 also take a leading lane axis (the multi-stream engine's B
streams, one launch for all): [B, T, H, hd] queries, [B, C, Hkv, hd]
arenas whose lanes may lie any 16-byte multiple apart (a layer of a [B, L,
C, Hkv, hd] arena), and per-lane visible lengths: host ints for K1 (its
plan is made on the host), an int32 device tensor [B] for K2 and K3 with
the host's largest beside it (`max_visible`, which sets the split). The
one-stream call is the lane form at B = 1. The lane forms' plain versions
(`*_lanes_plain`) loop over the lanes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..models.qwen25_vl.rope import apply_rope, make_inv_freq, mrope_cos_sin, rotate_half
from ._kernels import check_cuda, ptr, sm_count, stream
from .quant import QuantKV, dequantize_kv

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# one count per wrapper call that launched its kernel (a K2, K3 or K4 call
# launches a split pass and a combine pass; it counts once)
launch_counts = {
    "streaming_prefill_attention": 0,
    "streaming_decode_attention_full": 0,
    "streaming_decode_attention_int8": 0,
    "streaming_verify_attention": 0,
    "streaming_decode_attention": 0,
    "attention_bwd": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lead(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t with a lane axis of one (None stays None)."""
    return None if t is None else t[None]


def lane_lengths(visible_len, B: int) -> list:
    """Per-lane visible lengths as host ints: from an int (every lane), a
    sequence, or a [B] tensor (read from the device: plain versions only)."""
    if isinstance(visible_len, torch.Tensor):
        return [int(v) for v in visible_len.tolist()]
    if np.ndim(visible_len) == 0:
        return [int(visible_len)] * B
    return [int(v) for v in visible_len]


def _check_lanes(name: str, t: torch.Tensor, shape) -> int:
    """Raise unless t is a CUDA tensor of `shape` ([B, ...]) whose lanes are
    each contiguous and 16-byte aligned and lie a 16-byte multiple apart.
    Returns the lane stride in elements."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t[0].is_contiguous() or (t.shape[0] > 1 and (t.stride(0) * t.element_size()) % 16):
        raise ValueError(f"{name}: each lane must be contiguous, lanes 16 bytes apart")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return int(t.stride(0)) if t.shape[0] > 1 else int(t[0].numel())


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


# K1's work tile: packed (token, group-head) rows per row tile and keys per
# K/V tile (csrc/prefill_attention.cu BM and BN; the wrapper checks that the
# library agrees)
PREFILL_BLOCK_ROWS = 128
PREFILL_BLOCK_KEYS = 128


class PrefillPlan(NamedTuple):
    """Which CTA of K1 runs which work. A unit is one key tile of one row
    tile of one kv head of one lane; a row tile's units are its arena
    tiles, then its self tiles. The units, in (lane, kv head, row tile, key
    tile) order, are cut into one contiguous, equal (to one unit) share per
    CTA; a share's run within one row tile is a segment. A "head" is lane *
    Hkv + kv head (the kv head itself for one stream)."""

    segs: np.ndarray  # int32 [n_segs, 5]: head, row tile, first unit, end unit, partial slot
    # (-1: the segment covers all of the row tile's units and writes the output)
    cta_segs: np.ndarray  # int32 [n_ctas + 1]: CTA c runs segs[cta_segs[c] : cta_segs[c + 1]]
    merges: np.ndarray  # int32 [n_merges, 4]: head, row tile, first partial slot, count
    n_partials: int

    @property
    def n_ctas(self) -> int:
        return len(self.cta_segs) - 1


def prefill_units(T: int, G: int, visible_len: int) -> Tuple[int, np.ndarray]:
    """(arena units, self units of each row tile): ceil(visible_len / BN)
    arena tiles, and the self tiles up to each row tile's last token."""
    R = T * G
    rt = np.arange(-(-R // PREFILL_BLOCK_ROWS))
    t_last = (np.minimum((rt + 1) * PREFILL_BLOCK_ROWS, R) - 1) // G
    return -(-int(visible_len) // PREFILL_BLOCK_KEYS), t_last // PREFILL_BLOCK_KEYS + 1


def prefill_plan(T: int, G: int, Hkv: int, visible_len, n_sms: int) -> PrefillPlan:
    """K1's schedule over min(n_sms, units) CTAs (one per SM), for one
    stream (visible_len an int) or B lanes (a sequence of B lengths). A row
    tile whose units two or more CTAs share gets a partial slot per segment
    and one merge."""
    vis = lane_lengths(visible_len, 1)
    n_self = prefill_units(T, G, 0)[1]
    n_rt = len(n_self)
    # item i: head i // n_rt (lane head // Hkv, kv head head % Hkv), row tile i % n_rt
    units = np.concatenate([np.tile(prefill_units(T, G, v)[0] + n_self, Hkv) for v in vis])
    starts = np.concatenate([[0], np.cumsum(units)])
    n_ctas = min(int(n_sms), int(starts[-1]))
    bounds = np.arange(n_ctas + 1) * int(starts[-1]) // n_ctas
    segs, cta_segs = [], [0]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        i = int(np.searchsorted(starts, lo, side="right")) - 1
        while i < len(units) and starts[i] < hi:
            ub, ue = max(lo, starts[i]) - starts[i], min(hi, starts[i + 1]) - starts[i]
            whole = ub == 0 and ue == units[i]
            segs.append([i // n_rt, i % n_rt, ub, ue, -1 if whole else 0])
            i += 1
        cta_segs.append(len(segs))
    segs = np.array(segs, np.int32).reshape(-1, 5)
    split = segs[:, 4] == 0
    segs[split, 4] = np.arange(int(split.sum()))
    merges = []  # the segments of one row tile are consecutive, so are its slots
    for head, rt, _, _, slot in segs[split]:
        if merges and merges[-1][:2] == [head, rt]:
            merges[-1][3] += 1
        else:
            merges.append([head, rt, slot, 1])
    plan = PrefillPlan(segs, np.array(cta_segs, np.int32),
                       np.array(merges, np.int32).reshape(-1, 4), int(split.sum()))
    for a in plan[:3]:
        a.setflags(write=False)
    return plan


@functools.lru_cache(maxsize=32)
def _prefill_plan_on(device: torch.device, T: int, G: int, Hkv: int, visible: Tuple[int, ...],
                     n_sms: int) -> Tuple[PrefillPlan, torch.Tensor]:
    """The plan and its int32 copy on the device, laid out as the kernel
    reads it: segments, CTA offsets, merges, the lanes' visible lengths.
    Cached: the 28 layers of a chunk (or a multi-stream round) share one
    plan. The copy is staged in pinned memory and queued on the current
    stream, so the host does not wait for the device work already queued
    (PyTorch's pinned allocator keeps the staging buffer until the copy has
    run)."""
    plan = prefill_plan(T, G, Hkv, visible, n_sms)
    flat = np.concatenate([plan.segs.ravel(), plan.cta_segs, plan.merges.ravel(),
                           np.asarray(visible, np.int32)])
    staged = torch.from_numpy(flat.astype(np.int32)).pin_memory()
    return plan, staged.to(device, non_blocking=True)


def prefill_attention_by_plan(
    q_rot, k_arena, v_arena, acos2, asin2, k_self_rot, v_self, visible_len: int, n_sms: int,
) -> torch.Tensor:
    """K1's schedule in plain PyTorch, f32 math: the raw arena rotated once
    (and rounded to v's dtype), the scaled q rounded to q's dtype, then for
    each segment of `prefill_plan` the log2-space online softmax over its
    units with the kernel's masks, the output of whole segments normalised
    and the partials of split row tiles merged in log2 space. Returns [T,
    H, hd] in v's dtype; equal to `prefill_attention_plain` up to f32
    summation order."""
    T, H, hd = q_rot.shape
    Hkv = k_arena.shape[1]
    G, R, vis = H // Hkv, T * H // Hkv, int(visible_len)
    bm, bn = PREFILL_BLOCK_ROWS, PREFILL_BLOCK_KEYS
    plan = prefill_plan(T, G, Hkv, vis, n_sms)
    ka = k_arena[:vis]
    if acos2 is not None:
        ka = _rotate_dup_half(ka, acos2[:vis], asin2[:vis]).to(v_arena.dtype)
    qs = (q_rot.float() * (LOG2E / math.sqrt(hd))).to(q_rot.dtype).float()
    qp = qs.reshape(T, Hkv, G, hd).transpose(0, 1).reshape(Hkv, R, hd)  # packed rows
    n_arena = -(-vis // bn)
    out = torch.empty(Hkv, R, hd, dtype=torch.float32, device=q_rot.device)
    partials = {}
    for kvh, rt, ub, ue, slot in plan.segs.tolist():
        rows = torch.arange(rt * bm, min((rt + 1) * bm, R), device=q_rot.device)
        t = rows // G
        m = torch.full((len(rows),), -math.inf, device=q_rot.device)
        l = torch.zeros(len(rows), device=q_rot.device)
        acc = torch.zeros(len(rows), hd, device=q_rot.device)
        for u in range(ub, ue):
            if u < n_arena:
                keys = torch.arange(u * bn, min((u + 1) * bn, vis), device=q_rot.device)
                k, v, ok = ka[keys, kvh], v_arena[keys, kvh], None
            else:
                keys = torch.arange((u - n_arena) * bn, min((u - n_arena + 1) * bn, T),
                                    device=q_rot.device)
                k, v = k_self_rot[keys, kvh], v_self[keys, kvh]
                ok = keys[None, :] <= t[:, None]
            s = qp[kvh, rows] @ k.float().T
            if ok is not None:
                s = s.masked_fill(~ok, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            p = torch.exp2(s - base[:, None])
            alpha = torch.exp2(m - base)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[:, None] + p @ v.float()
            m = m_new
        if slot < 0:
            out[kvh, rows] = acc / l.clamp_min(1e-20)[:, None]
        else:
            partials[slot] = (rows, m, l, acc)
    for kvh, _, p0, n in plan.merges.tolist():
        rows = partials[p0][0]
        ms, ls, accs = (torch.stack([partials[p0 + i][j] for i in range(n)]) for j in (1, 2, 3))
        w = torch.exp2(ms - ms.amax(dim=0))
        out[kvh, rows] = (w[..., None] * accs).sum(0) / (w * ls).sum(0).clamp_min(1e-20)[:, None]
    return out.reshape(Hkv, T, G, hd).transpose(0, 1).reshape(T, H, hd).to(v_arena.dtype)


def prefill_lse_plain(
    q_rot, k_arena, acos2, asin2, k_self_rot, visible_len: int
) -> torch.Tensor:
    """Plain version of K1's log-sum-exp output: for each query row, log2 of
    the sum of exp2 of its K1 logits over arena slots < visible_len and the
    causal self block, in f32, with K1's q (scaled by softmax-scale *
    log2(e), then rounded to q's dtype). Returns [T, H] f32: P = exp2(s2 -
    lse2), and the natural log-sum-exp is lse2 * ln(2)."""
    T, H, hd = q_rot.shape
    Hkv = k_self_rot.shape[1]
    vis = int(visible_len)
    ka = k_arena[:vis]
    if acos2 is not None:
        ka = _rotate_dup_half(ka, acos2[:vis], asin2[:vis]).to(k_self_rot.dtype)
    qs = (q_rot.float() * (LOG2E / math.sqrt(hd))).to(q_rot.dtype).float()
    qg = qs.reshape(T, Hkv, H // Hkv, hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=q_rot.device).tril()
    s2 = torch.einsum("tkgd,skd->tkgs", qg, k_self_rot.float())
    s2 = s2.masked_fill(~causal[:, None, None, :], -math.inf)
    if vis:
        s2 = torch.cat([torch.einsum("tkgd,skd->tkgs", qg, ka.float()), s2], -1)
    m = s2.amax(dim=-1, keepdim=True)
    lse2 = m + torch.log2(torch.exp2(s2 - m).sum(dim=-1, keepdim=True))
    return lse2.reshape(T, H)


def prefill_attention_lanes_plain(
    q_rot, k_arena, v_arena, acos2, asin2, k_self_rot, v_self, visible_len
) -> torch.Tensor:
    """Plain version of K1's lane form: `prefill_attention_plain` for each
    lane of [B, ...] inputs (visible_len: one length or B). Returns [B, T,
    H, hd] in v's dtype."""
    B = q_rot.shape[0]
    vis = lane_lengths(visible_len, B)
    return torch.stack([
        prefill_attention_plain(
            q_rot[b], k_arena[b], v_arena[b], None if acos2 is None else acos2[b],
            None if asin2 is None else asin2[b], k_self_rot[b], v_self[b], vis[b])
        for b in range(B)])


def streaming_prefill_attention(
    q_rot: torch.Tensor,  # [T, H, hd] rotated queries (unscaled), or [B, T, H, hd]
    k_arena: torch.Tensor,  # [C, Hkv, hd] raw, or pre-rotated if acos2 is None; or [B, C, Hkv, hd]
    v_arena: torch.Tensor,  # [C, Hkv, hd], or [B, C, Hkv, hd]
    acos2: Optional[torch.Tensor],  # [C, hd] f32 duplicated-half cos ([B, C, hd]), or None
    asin2: Optional[torch.Tensor],
    k_self_rot: torch.Tensor,  # [T, Hkv, hd], or [B, T, Hkv, hd]
    v_self: torch.Tensor,
    visible_len,  # int, or B host ints (the lane form)
    *,
    lse: Optional[torch.Tensor] = None,  # f32 [T, H] ([B, T, H]) out, or None
) -> torch.Tensor:
    """K1. Returns attention output [T, H, hd] (lane form: [B, T, H, hd]) in
    v's dtype. On the card: raw mode's rotate pass (into a [B, max visible,
    Hkv, hd] bf16 scratch), the attention over `prefill_plan`'s CTAs (all
    lanes' work in one grid), and the merge of split row tiles, one counted
    launch. The lane form's arenas may be lane-strided views. Given `lse`,
    each row's log2-space log-sum-exp (`prefill_lse_plain`) is written into
    it too (training's forward saves it for K1-bwd)."""
    if q_rot.dim() == 3:  # one stream: the lane form at B = 1
        return streaming_prefill_attention(
            q_rot[None], k_arena[None], v_arena[None], _lead(acos2), _lead(asin2),
            k_self_rot[None], v_self[None], [int(visible_len)], lse=_lead(lse))[0]
    B, T, H, hd = q_rot.shape
    vis = lane_lengths(visible_len, B)
    if len(vis) != B:
        raise ValueError(f"streaming_prefill_attention: {len(vis)} visible lengths for {B} lanes")
    if lse is not None and (lse.shape != (B, T, H) or lse.dtype != torch.float32
                            or lse.device != q_rot.device):
        raise ValueError("streaming_prefill_attention: lse must be f32 [T, H] ([B, T, H]) on "
                         "q's device")
    if q_rot.device.type == "cpu":
        if lse is not None:
            for b in range(B):
                c2 = None if acos2 is None else acos2[b]
                s2 = None if asin2 is None else asin2[b]
                lse[b] = prefill_lse_plain(q_rot[b], k_arena[b], c2, s2, k_self_rot[b], vis[b])
        return prefill_attention_lanes_plain(
            q_rot, k_arena, v_arena, acos2, asin2, k_self_rot, v_self, vis
        )
    name = "streaming_prefill_attention"
    C, Hkv = k_arena.shape[1], k_arena.shape[2]
    check_cuda(name, q_rot, k_self_rot, v_self)
    ka_lane = _check_lanes(name, k_arena, (B, C, Hkv, hd))
    va_lane = _check_lanes(name, v_arena, (B, C, Hkv, hd))
    tensors = [q_rot, k_arena, v_arena, k_self_rot, v_self]
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    if hd != 128 or H % Hkv:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} arena={tuple(k_arena.shape)}")
    if k_self_rot.shape != (B, T, Hkv, hd) or v_self.shape != (B, T, Hkv, hd):
        raise ValueError(f"{name}: self block must be [B, T, Hkv, hd]")
    if not all(0 <= v <= C for v in vis):
        raise ValueError(f"{name}: visible lengths {vis} outside [0, {C}]")
    if (acos2 is None) != (asin2 is None):
        raise ValueError(f"{name}: pass both acos2 and asin2, or neither")
    if acos2 is not None:
        check_cuda(name, acos2, asin2)
        if acos2.dtype != torch.float32 or acos2.shape != (B, C, hd) or asin2.shape != (B, C, hd):
            raise ValueError(f"{name}: acos2/asin2 must be f32 [B, C, hd]")
    if lse is not None:
        check_cuda(name, lse)
    from ._kernels import lib

    so = lib()
    if so.prefill_block != (PREFILL_BLOCK_ROWS, PREFILL_BLOCK_KEYS):
        raise RuntimeError(f"{name}: the library's tile {so.prefill_block} is not the plan's")
    dev = q_rot.device
    vis_max = max(vis)
    plan, plan_dev = _prefill_plan_on(dev, T, H // Hkv, Hkv, tuple(vis), sm_count(dev))
    out = torch.empty_like(q_rot)
    part_o = torch.empty(plan.n_partials, PREFILL_BLOCK_ROWS, hd, dtype=torch.float32, device=dev)
    part_ml = torch.empty(plan.n_partials, 2, PREFILL_BLOCK_ROWS, dtype=torch.float32, device=dev)
    k_rot = (torch.empty(B, vis_max, Hkv, hd, dtype=torch.bfloat16, device=dev)
             if acos2 is not None and vis_max else None)
    err = so.svt_prefill_attention(
        ptr(q_rot), ptr(k_arena), ptr(v_arena), ptr(acos2), ptr(asin2), ptr(k_rot),
        ptr(k_self_rot), ptr(v_self), ptr(out), ptr(part_o), ptr(part_ml), ptr(lse), ptr(plan_dev),
        plan.n_ctas, len(plan.segs), len(plan.merges), B, T, H, Hkv, hd, C, vis_max,
        ka_lane, va_lane, stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# Training attention: K1 forward (with each row's log-sum-exp) + K1-bwd
# ---------------------------------------------------------------------------

TRAIN_GMAX = 8  # the largest GQA group training's kernels take


def _attention_rows(q, k, v, r0: int):
    """Causal attention of query rows r0 .. r0 + len(q) over keys k, v [S,
    Hkv, hd] with the JAX package's per-row math and dtype chain
    (`_gqa_attention_chunked`'s block): f32 logits, max-subtracted exp, P
    cast to v's dtype for P.V, times 1 / sum cast to the output's dtype.
    Returns (out [t, H * hd] in v's dtype, natural log-sum-exp [t, H] f32)."""
    t, H, hd = q.shape
    S, Hkv, _ = k.shape
    G = H // Hkv
    rows = torch.arange(r0, r0 + t, device=q.device)
    mask = torch.arange(S, device=q.device)[None, :] <= rows[:, None]
    lg = torch.einsum("tkgd,skd->kgts", q.float().reshape(t, Hkv, G, hd), k.float())
    lg = torch.where(mask[None, None], lg * (1.0 / math.sqrt(hd)), NEG_INF)
    m = lg.amax(dim=-1, keepdim=True)
    e = torch.exp(lg - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("kgts,skd->tkgd", e.to(v.dtype), v)
    inv = (1.0 / denom).to(o.dtype)
    out = (o * inv.permute(2, 0, 1, 3)).reshape(t, H * hd)
    lse = (m + torch.log(denom)).reshape(H, t).transpose(0, 1)
    return out, lse


def train_attention_plain(
    q_rot: torch.Tensor,  # [T, H, hd] rotated
    k_rot: torch.Tensor,  # [T, Hkv, hd] rotated
    v: torch.Tensor,  # [T, Hkv, hd]
    q_block: int = 0,
    *,
    return_lse: bool = False,
):
    """Plain causal GQA self-attention for training, differentiable by
    autograd: the JAX package's `_gqa_attention_chunked` (q_block > 0: row
    blocks of q_block under torch.utils.checkpoint, so the backward
    recomputes each block's [Hkv, G, q_block, T] logits and holds O(q_block
    T) of them) or its naive form (q_block 0: one block of all rows), the
    same per-row math either way. Returns [T, H * hd] in v's dtype, and with
    return_lse the rows' log2-space log-sum-exp [T, H] f32 (K1's
    convention: natural log-sum-exp * log2(e))."""
    T = q_rot.shape[0]
    step = int(q_block) if q_block and q_block > 0 else T
    outs, lses = [], []
    for r0 in range(0, T, step):
        qi = q_rot[r0:r0 + step]
        if step < T and torch.is_grad_enabled():
            out, lse = torch.utils.checkpoint.checkpoint(
                _attention_rows, qi, k_rot, v, r0, use_reentrant=False)
        else:
            out, lse = _attention_rows(qi, k_rot, v, r0)
        outs.append(out)
        lses.append(lse)
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    if not return_lse:
        return out
    return out, torch.cat(lses) * LOG2E


def train_attention_bwd_plain(q_rot, k_rot, v, out, lse2, d_out, q_block: int = 0):
    """The backward algebra K1-bwd implements, in f32 from the given
    tensors: with the saved output O [T, H, hd] and log2-space log-sum-exp
    lse2 [T, H], P = exp2(s2 - lse2) over the causal keys (s2 = q.k *
    softmax-scale * log2(e)), D = rowsum(dO * O), dS = P (dP - D) with dP =
    dO.v; dQ = dS.k * scale, dK = dS^T.q * scale and dV = P^T.dO, dK and dV
    summed over each kv head's G query heads. Query rows are taken q_block
    at a time (0: all at once). Returns f32 (dq [T, H, hd], dk, dv [T, Hkv,
    hd])."""
    T, H, hd = q_rot.shape
    Hkv = k_rot.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q_rot.float().reshape(T, Hkv, G, hd)
    kf, vf = k_rot.float(), v.float()
    dof = d_out.float().reshape(T, Hkv, G, hd)
    dsum = (dof * out.float().reshape(T, Hkv, G, hd)).sum(-1)  # [T, Hkv, G]
    l2 = lse2.float().reshape(T, Hkv, G)
    dq = torch.empty(T, Hkv, G, hd, dtype=torch.float32, device=q_rot.device)
    dk = torch.zeros(T, Hkv, hd, dtype=torch.float32, device=q_rot.device)
    dv = torch.zeros_like(dk)
    step = int(q_block) if q_block and q_block > 0 else T
    keys = torch.arange(T, device=q_rot.device)
    for r0 in range(0, T, step):
        r1 = min(r0 + step, T)
        causal = keys[None, :] <= torch.arange(r0, r1, device=q_rot.device)[:, None]
        s2 = torch.einsum("tkgd,skd->kgts", qf[r0:r1], kf) * (LOG2E * scale)
        p = torch.where(causal[None, None], torch.exp2(s2 - l2[r0:r1].permute(1, 2, 0)[..., None]),
                        0.0)
        dp = torch.einsum("tkgd,skd->kgts", dof[r0:r1], vf)
        ds = p * (dp - dsum[r0:r1].permute(1, 2, 0)[..., None])
        dq[r0:r1] = torch.einsum("kgts,skd->tkgd", ds, kf) * scale
        dk += torch.einsum("kgts,tkgd->skd", ds, qf[r0:r1]) * scale
        dv += torch.einsum("kgts,tkgd->skd", p, dof[r0:r1])
    return dq.reshape(T, H, hd), dk, dv


# K1-bwd's tiling (csrc/attention_bwd.cu BN and ROWS): a CTA owns a block of
# 128 keys of one kv head; a row tile holds the packed rows of 64 // G whole
# tokens (63 at G = 7)
BWD_BLOCK_KEYS = 128
BWD_TILE_ROWS = 64


def attention_bwd_tiles(T: int, G: int) -> Tuple[int, int]:
    """K1-bwd's row tiles at T tokens and group G, as the kernel derives
    them: (whole tokens a tile, 64 // G; tiles). The wrapper sizes its
    scratch by them; tests/test_torch_bwd_plan.py models the schedule."""
    bt = BWD_TILE_ROWS // G
    return bt, -(-T // bt)


def attention_bwd_scratch(T: int, H: int, Hkv: int, hd: int, device) -> Tuple[torch.Tensor, ...]:
    """K1-bwd's scratch at T tokens, H query and Hkv kv heads, uninitialised
    (the pre pass fills it): each row tile's (lse2, D) record f32 [Hkv, M,
    2 * 64], the per-tile fold counters and the ticket int32 [Hkv M + 1] and
    the dQ accumulator f32 [Hkv, M, 64, hd], M = `attention_bwd_tiles`' tiles.
    On device "meta" it only reckons the bytes."""
    M = attention_bwd_tiles(T, H // Hkv)[1]
    return (torch.empty(Hkv, M, 2 * BWD_TILE_ROWS, dtype=torch.float32, device=device),
            torch.empty(Hkv * M + 1, dtype=torch.int32, device=device),
            torch.empty(Hkv, M, BWD_TILE_ROWS, hd, dtype=torch.float32, device=device))


def _check_train_shapes(name: str, q_rot, k_rot, v) -> None:
    """Raise unless q [T, H, 128], k and v [T, Hkv, 128] with H = G Hkv, G <=
    TRAIN_GMAX, bf16 on a CUDA device (what K1 and K1-bwd take)."""
    T, H, hd = q_rot.shape
    Hkv = k_rot.shape[1]
    if hd != 128 or H % Hkv or H // Hkv > TRAIN_GMAX or k_rot.shape != (T, Hkv, hd) \
            or v.shape != (T, Hkv, hd):
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} "
                         f"k={tuple(k_rot.shape)} v={tuple(v.shape)} (head_dim 128, G <= "
                         f"{TRAIN_GMAX})")
    if any(t.dtype != torch.bfloat16 for t in (q_rot, k_rot, v)):
        raise ValueError(f"{name}: the CUDA kernels take bf16 q/k/v, got {q_rot.dtype}")


def attention_bwd(q_rot, k_rot, v, out, lse2, d_out):
    """K1-bwd: dq [T, H, hd], dk, dv [T, Hkv, hd] of causal GQA attention
    from the saved output and log2-space log-sum-exp (`train_attention_bwd_
    plain`'s algebra), in the inputs' dtype. On the card: a pre pass (D and
    each row tile's (lse2, D) record), the main kernel (the five products
    once, dQ partials folded in a fixed order: bitwise repeatable) and a
    post pass rounding dQ (csrc/attention_bwd.cu; its row tiles
    `attention_bwd_tiles`, its scratch `attention_bwd_scratch`), one
    counted launch. On the CPU: the plain
    version."""
    if q_rot.device.type == "cpu":
        dq, dk, dv = train_attention_bwd_plain(q_rot, k_rot, v, out, lse2, d_out)
        return dq.to(q_rot.dtype), dk.to(k_rot.dtype), dv.to(v.dtype)
    name = "attention_bwd"
    _check_train_shapes(name, q_rot, k_rot, v)
    T, H, hd = q_rot.shape
    Hkv = k_rot.shape[1]
    check_cuda(name, q_rot, k_rot, v, out, lse2, d_out)
    if out.shape != q_rot.shape or d_out.shape != q_rot.shape or out.dtype != torch.bfloat16 \
            or d_out.dtype != torch.bfloat16:
        raise ValueError(f"{name}: out and d_out must be bf16 [T, H, hd] like q")
    if lse2.shape != (T, H) or lse2.dtype != torch.float32:
        raise ValueError(f"{name}: lse2 must be f32 [T, H]")
    from ._kernels import lib

    if lib().bwd_block != (BWD_BLOCK_KEYS, BWD_TILE_ROWS):
        raise RuntimeError(f"{name}: the library's tiles {lib().bwd_block} are not the schedule's")
    dq, dk, dv = torch.empty_like(q_rot), torch.empty_like(k_rot), torch.empty_like(v)
    rec, counters, dq_acc = attention_bwd_scratch(T, H, Hkv, hd, q_rot.device)
    err = lib().svt_attention_bwd(
        ptr(q_rot), ptr(k_rot), ptr(v), ptr(out), ptr(lse2), ptr(d_out), ptr(rec),
        ptr(counters), ptr(dq_acc), ptr(dq), ptr(dk), ptr(dv), T, H, Hkv, hd, stream())
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return dq, dk, dv


class _TrainAttention(torch.autograd.Function):
    """Causal self-attention whose forward saves O and each row's log2-space
    log-sum-exp and whose backward is K1-bwd's algebra: on the card K1 at
    visible 0 (with lse) and K1-bwd; on the CPU their plain versions."""

    @staticmethod
    def forward(ctx, q_rot, k_rot, v, q_block):
        T, H, hd = q_rot.shape
        if q_rot.device.type == "cpu":
            out, lse2 = train_attention_plain(q_rot, k_rot, v, q_block, return_lse=True)
            out = out.reshape(T, H, hd)
        else:  # train_attention checked the shapes
            lse2 = torch.empty(T, H, dtype=torch.float32, device=q_rot.device)
            # visible 0: the arena is never read (k stands in for it)
            out = streaming_prefill_attention(q_rot, k_rot, v, None, None, k_rot, v, 0, lse=lse2)
        ctx.save_for_backward(q_rot, k_rot, v, out, lse2)
        ctx.q_block = q_block
        return out.reshape(T, H * hd)

    @staticmethod
    def backward(ctx, grad):
        q_rot, k_rot, v, out, lse2 = ctx.saved_tensors
        d_out = grad.reshape(out.shape).to(out.dtype).contiguous()
        if q_rot.device.type == "cpu":
            dq, dk, dv = train_attention_bwd_plain(q_rot, k_rot, v, out, lse2, d_out, ctx.q_block)
            dq, dk, dv = dq.to(q_rot.dtype), dk.to(k_rot.dtype), dv.to(v.dtype)
        else:
            dq, dk, dv = attention_bwd(q_rot, k_rot, v, out, lse2, d_out)
        return dq, dk, dv, None


def train_attention(
    q_rot: torch.Tensor,  # [T, H, hd] rotated
    k_rot: torch.Tensor,  # [T, Hkv, hd] rotated
    v: torch.Tensor,  # [T, Hkv, hd]
    q_block: int = 0,
) -> torch.Tensor:
    """Causal GQA self-attention for training, [T, H * hd] in v's dtype, as a
    torch.autograd.Function. On a CUDA tensor (bf16, head_dim 128, G <= 8;
    anything else raises ValueError, nothing falls back) the forward is K1
    at visible 0, which also writes each row's log-sum-exp, and the backward
    is K1-bwd; both hold O(T) memory whatever q_block is. On a CPU tensor the
    forward is `train_attention_plain` (q_block row blocks: its memory) and
    the backward `train_attention_bwd_plain`."""
    if q_rot.device.type != "cpu":
        _check_train_shapes("train_attention", q_rot, k_rot, v)
    return _TrainAttention.apply(q_rot.contiguous(), k_rot.contiguous(), v.contiguous(),
                                 int(q_block or 0))


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


# The decode kernels' split (K2, K3 and K4): the host picks how many visible
# slots one CTA stages, so that every visible length gives a grid that fills
# the card
DECODE_SPLIT_ALIGN = 8  # split sizes are multiples of this
DECODE_CTAS_PER_SM = 2  # CTAs of the split pass resident on one SM (shared memory)


# K2-verify's split: its CTA stages up to 384 rows (most of an SM's shared
# memory), one CTA an SM, and the last CTA of each kv head folds every
# part's partials of all T x G query rows at one SM's rate, so its parts
# are fewer and larger than K2's
VERIFY_SPLIT_ALIGN = 32  # whole 32-key steps (STEP in csrc/verify_attention.cu)
VERIFY_CTAS_PER_SM = 1
# a split of ~sqrt(VERIFY_SPLIT_BALANCE * visible_len) rows balances a
# CTA's rows (~split) against the fold's parts (~visible_len / split); the
# constant is fitted to tools/profile_verify_torch.py's sweep on an H100
VERIFY_SPLIT_BALANCE = 18


def decode_split_size(visible_len: int, Hkv: int, n_sms: int, max_split: int = 160,
                      lanes: int = 1, *, ctas_per_sm: int = DECODE_CTAS_PER_SM,
                      align: int = DECODE_SPLIT_ALIGN) -> int:
    """Slots per split of the decode kernels' split pass (K2, K3, K4): as
    few as give the kv heads' splits plus the small-block CTAs (K2's and
    K3's, one per kv head) of all `lanes` one wave of `ctas_per_sm` CTAs
    per SM, in multiples of `align`, at most max_split (the kernel's tile:
    TILE in csrc/decode_attention.cu and csrc/decode_attention_raw.cu).
    The lane form passes its largest visible length. K2-verify passes
    VERIFY_CTAS_PER_SM and VERIFY_SPLIT_ALIGN (`verify_split_size`)."""
    heads = int(lanes) * Hkv
    per_head = max((int(ctas_per_sm) * int(n_sms) - heads) // heads, 1)
    split = -(-int(visible_len) // per_head)
    split = -(-split // align) * align
    return int(min(max(split, align), max_split))


def decode_max_parts(capacity: int, Hkv: int, n_sms: int, max_split: int = 160,
                     lanes: int = 1, *, ctas_per_sm: int = DECODE_CTAS_PER_SM) -> int:
    """The most parts (splits + the small block) a decode call over at most
    `capacity` visible slots can have: what one lane's scratch must hold."""
    heads = int(lanes) * Hkv
    per_head = max((int(ctas_per_sm) * int(n_sms) - heads) // heads, 1)
    return max(per_head, -(-int(capacity) // max_split)) + 1


def verify_split_size(visible_len: int, Hkv: int, n_sms: int, max_split: int = 384) -> int:
    """Slots per split of K2-verify (csrc/verify_attention.cu, whose tile
    holds max_split rows), in whole 32-key steps: ~sqrt(VERIFY_SPLIT_BALANCE
    * visible_len), and at least as many as keep the kv heads' splits and
    small blocks to one wave of one CTA an SM."""
    one_wave = decode_split_size(visible_len, Hkv, n_sms, max_split,
                                 ctas_per_sm=VERIFY_CTAS_PER_SM, align=VERIFY_SPLIT_ALIGN)
    balance = math.ceil(math.sqrt(VERIFY_SPLIT_BALANCE * int(visible_len)) / VERIFY_SPLIT_ALIGN)
    return int(min(max(one_wave, balance * VERIFY_SPLIT_ALIGN), max_split))


def decode_splits(visible_len: int, split: int) -> list:
    """The arena slot ranges [lo, hi) of the splits of visible_len slots."""
    return [(lo, min(lo + split, int(visible_len))) for lo in range(0, int(visible_len), split)]


def _log2_partial(qs, k, v, mask):
    """One part's log2-space softmax partial over its rows, f32: qs [Hkv,
    G, hd] scaled queries, k / v [S, Hkv, hd], mask [S] bool (or None).
    Returns (m [Hkv, G], l [Hkv, G], acc [Hkv, G, hd]); a part with no
    visible row gives m = -inf, l = 0, acc = 0."""
    s = torch.einsum("kgd,skd->kgs", qs, k.float())
    if mask is not None:
        s = s.masked_fill(~mask[None, None, :], -math.inf)
    m = s.amax(dim=-1) if s.shape[-1] else torch.full(s.shape[:2], -math.inf, device=s.device)
    p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m)[..., None])
    return m, p.sum(dim=-1), torch.einsum("kgs,skd->kgd", p, v.float())


def _merge_partials(parts):
    """Fold log2-space partials (m, l, acc) into (m, l, acc) merged, f32."""
    ms = torch.stack([m for m, _, _ in parts])
    mx = ms.amax(dim=0)
    w = torch.where(ms == -math.inf, 0.0, torch.exp2(ms - mx))
    l = (w * torch.stack([l for _, l, _ in parts])).sum(0)
    acc = (w[..., None] * torch.stack([a for _, _, a in parts])).sum(0)
    return mx, l, acc


def decode_attention_by_splits(
    q_rot, k_arena, v_arena, k_small, v_small, visible_len: int, extra_visible: int, *,
    e_delta: int, split: int,
) -> torch.Tensor:
    """K2's schedule in plain PyTorch, f32 math: the scaled q, one
    log2-space partial per split of `decode_splits(visible_len, split)` and
    one for the small block (delta rows below extra_visible, self rows),
    merged with one softmax. Returns [H, hd] in v_small's dtype; equal to
    `decode_attention_plain` up to f32 summation order."""
    H, hd = q_rot.shape
    Hkv = k_arena.shape[1]
    qs = q_rot.float().reshape(Hkv, H // Hkv, hd) * (LOG2E / math.sqrt(hd))
    parts = [_log2_partial(qs, k_arena[lo:hi], v_arena[lo:hi], None)
             for lo, hi in decode_splits(visible_len, split)]
    col = torch.arange(k_small.shape[0], device=q_rot.device)
    parts.append(_log2_partial(qs, k_small, v_small, (col < int(extra_visible)) | (col >= e_delta)))
    _, l, acc = _merge_partials(parts)
    return (acc / l.clamp_min(1e-20)[..., None]).reshape(H, hd).to(v_small.dtype)


_decode_scratch_cache = {}  # device -> (f32 partials, int32 counters kept zero by the kernels)


def _decode_scratch(device, lanes: int, Hkv: int, n_parts: int, G: int, hd: int):
    """The decode kernels' partials (m, l [lanes * Hkv, n_parts, G], acc
    [lanes * Hkv, n_parts, G, hd]) and per-(lane, kv head) counters, as
    views of a per-device cache that grows to the largest call seen (an
    engine sizes it once, up front: `reserve_decode_scratch`). K2, K3 and
    K4 share this one scratch and this one set of counters: each call's
    last CTA per (lane, kv head) resets its counter to zero, and calls on
    one stream run in order, so they may. Calls on two streams at once, or
    a CUDA graph captured before the cache grows, may not."""
    heads = int(lanes) * Hkv
    n_ml = -(-heads * n_parts * G // 4) * 4  # keeps acc 16-byte aligned
    need = 2 * n_ml + heads * n_parts * G * hd
    have = _decode_scratch_cache.get(device)
    if have is None or have[0].numel() < need or have[1].numel() < heads:
        old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.empty(max(need, old[0]), dtype=torch.float32, device=device),
                torch.zeros(max(heads, old[1]), dtype=torch.int32, device=device))
        _decode_scratch_cache[device] = have
    buf, counters = have
    shape = (heads, n_parts, G)
    n = heads * n_parts * G
    return (buf[:n].view(shape), buf[n_ml : n_ml + n].view(shape),
            buf[2 * n_ml : need].view(*shape, hd), counters)


def reserve_decode_scratch(device, lanes: int, Hkv: int, capacity: int, G: int, hd: int,
                           verify_queries: int = 0) -> None:
    """Size the shared decode scratch for `lanes` lanes over an arena of
    `capacity` slots (K2's and K3's largest split count), and with
    `verify_queries` for K2-verify's T queries of one stream (their
    partials take T heads' rows), so that no call of an engine's rounds
    grows it. A no-op off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    from ._kernels import lib

    so = lib()
    sms = sm_count(device)
    n = max(decode_max_parts(capacity, Hkv, sms, m, lanes)
            for m in (so.decode_max_split, so.raw_decode_max_split))
    _decode_scratch(device, lanes, Hkv, n, G, hd)
    if verify_queries:
        _decode_scratch(device, verify_queries, Hkv,
                        decode_max_parts(capacity, Hkv, sms, so.verify_max_split,
                                         ctas_per_sm=VERIFY_CTAS_PER_SM), G, hd)


def _decode_parts(name: str, visible_len: int, Hkv: int, device, max_split: int,
                  max_parts: int, lanes: int = 1) -> Tuple[int, int]:
    """(split, arena splits) of a K2, K3 or K4 call on `device` over at most
    visible_len slots a lane, for a kernel whose tile holds max_split rows
    and whose combine folds at most max_parts parts."""
    split = decode_split_size(visible_len, Hkv, sm_count(device), max_split, lanes)
    n = -(-visible_len // split)
    if n + 1 > max_parts:
        raise ValueError(f"{name}: visible_len {visible_len} needs {n} splits of {split}, more "
                         f"than the kernel's {max_parts - 1}")
    return split, n


def decode_attention_lanes_plain(
    q_rot, k_arena, v_arena, k_small, v_small, visible_len, extra_visible: int, *, e_delta: int,
) -> torch.Tensor:
    """Plain version of K2's lane form: `decode_attention_plain` for each
    lane of [B, ...] inputs (visible_len: one length, B ints or a [B]
    tensor). Returns [B, H, hd] in v_small's dtype."""
    B = q_rot.shape[0]
    vis = lane_lengths(visible_len, B)
    return torch.stack([
        decode_attention_plain(q_rot[b], k_arena[b], v_arena[b], k_small[b], v_small[b], vis[b],
                               extra_visible, e_delta=e_delta)
        for b in range(B)])


def _decode_lengths(name: str, visible_len, max_visible, B: int, device):
    """(device lengths or None, the host's largest) for a decode kernel's
    lane form: an int is every lane's length (no device array); a tensor
    must be int32 [B] on the card, beside max_visible."""
    if not isinstance(visible_len, torch.Tensor):
        return None, int(visible_len)
    if max_visible is None:
        raise ValueError(f"{name}: a device tensor of lengths needs max_visible (the largest)")
    if visible_len.dtype != torch.int32 or visible_len.shape != (B,) or visible_len.device != device:
        raise ValueError(f"{name}: visible_len must be int32 [{B}] on {device}")
    return visible_len, int(max_visible)


def streaming_decode_attention_full(
    q_rot: torch.Tensor,  # [H, hd] rotated single-token queries (unscaled), or [B, H, hd]
    k_arena: torch.Tensor,  # [C, Hkv, hd] pre-rotated arena K, or [B, C, Hkv, hd]
    v_arena: torch.Tensor,
    k_small: torch.Tensor,  # [e_delta + 1, Hkv, hd] rotated delta rows ++ self row ([B, ...])
    v_small: torch.Tensor,
    visible_len,  # int, or (lane form) an int32 [B] tensor on the card
    extra_visible: int,
    *,
    e_delta: int,
    max_visible: Optional[int] = None,  # lane form: the largest of visible_len (host)
) -> torch.Tensor:
    """K2. Returns [H, hd] (lane form: [B, H, hd]) in v_small's dtype.

    No-padding contract (as the TPU kernel's): k_small holds exactly
    e_delta delta rows followed by the self row(s), every one of which is
    visible; a padded k_small would let pad rows join the softmax.

    The lane form is one launch for B streams: grid (splits + the small
    block, Hkv, B), the split chosen from max_visible; lane b reads its
    length from visible_len[b] on the card (each must be <= max_visible)."""
    if q_rot.dim() == 2:  # one stream: the lane form at B = 1
        return streaming_decode_attention_full(
            q_rot[None], k_arena[None], v_arena[None], k_small[None], v_small[None],
            int(visible_len), extra_visible, e_delta=e_delta)[0]
    B, H, hd = q_rot.shape
    E1 = k_small.shape[1]
    if E1 <= e_delta or v_small.shape != k_small.shape:
        raise ValueError(f"no-padding contract: k_small rows {E1} must exceed e_delta {e_delta}")
    if q_rot.device.type == "cpu":
        return decode_attention_lanes_plain(
            q_rot, k_arena, v_arena, k_small, v_small, visible_len, extra_visible,
            e_delta=e_delta,
        )
    name = "streaming_decode_attention_full"
    C, Hkv = k_arena.shape[1], k_arena.shape[2]
    check_cuda(name, q_rot, k_small, v_small)
    ka_lane = _check_lanes(name, k_arena, (B, C, Hkv, hd))
    va_lane = _check_lanes(name, v_arena, (B, C, Hkv, hd))
    if any(t.dtype != torch.bfloat16 for t in (q_rot, k_arena, v_arena, k_small, v_small)):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    from ._kernels import lib

    so = lib()
    if hd != 128 or H % Hkv or H // Hkv > 8:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} arena={tuple(k_arena.shape)}")
    if k_small.shape[2:] != (Hkv, hd) or k_small.shape[0] != B or E1 > so.decode_max_small_rows:
        raise ValueError(f"{name}: k_small must be [B, <= {so.decode_max_small_rows}, Hkv, hd]")
    vis_dev, vis_max = _decode_lengths(name, visible_len, max_visible, B, q_rot.device)
    if not 0 <= vis_max <= C or not 0 <= int(extra_visible) <= e_delta:
        raise ValueError(f"{name}: visible_len {vis_max} / extra_visible {extra_visible} out of range")
    split, n_splits = _decode_parts(name, vis_max, Hkv, q_rot.device, so.decode_max_split,
                                    so.decode_max_parts, B)
    part_m, part_l, part_acc, counters = _decode_scratch(q_rot.device, B, Hkv, n_splits + 1,
                                                         H // Hkv, hd)
    out = torch.empty(B, H, hd, dtype=v_small.dtype, device=q_rot.device)
    err = so.svt_decode_attention(
        ptr(q_rot), ptr(k_arena), ptr(v_arena), ptr(k_small), ptr(v_small),
        ptr(part_m), ptr(part_l), ptr(part_acc), ptr(counters), ptr(out), ptr(vis_dev), B, H, Hkv,
        hd, E1, int(e_delta), vis_max, int(extra_visible), split, ka_lane, va_lane, stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# K2-verify: T queries of one stream over arena + decode delta + causal self
# ---------------------------------------------------------------------------


def verify_small_mask(T: int, e1: int, extra_visible: int, e_delta: int, device) -> torch.Tensor:
    """[T, e1] bool: query t sees delta rows < extra_visible and self rows
    e_delta .. e_delta + t of the small block."""
    col = torch.arange(e1, device=device)[None, :]
    t = torch.arange(T, device=device)[:, None]
    return (col < int(extra_visible)) | ((col >= e_delta) & (col <= e_delta + t))


def verify_attention_plain(
    q_rot, k_arena, v_arena, k_small, v_small, visible_len: int, extra_visible: int, *,
    e_delta: int,
) -> torch.Tensor:
    """Plain version of K2-verify: f32 joint softmax of each of the T
    queries over arena slots < visible_len, delta rows k_small[:e_delta]
    below extra_visible, and the self rows k_small[e_delta:e_delta + t + 1]
    (causal). Returns [T, H, hd] in v_small's dtype; at T == 1 it is
    `decode_attention_plain`."""
    T, H, hd = q_rot.shape
    dev = q_rot.device
    vis = int(visible_len)
    parts = [(k_small, v_small,
              verify_small_mask(T, k_small.shape[0], extra_visible, e_delta, dev))]
    if vis:
        parts.insert(
            0, (k_arena[:vis], v_arena[:vis], torch.ones(T, vis, dtype=torch.bool, device=dev))
        )
    return gqa_attention_multi(q_rot, parts).reshape(T, H, hd).to(v_small.dtype)


def streaming_verify_attention(
    q_rot: torch.Tensor,  # [T, H, hd] rotated queries of the T verify tokens (unscaled)
    k_arena: torch.Tensor,  # [C, Hkv, hd] pre-rotated arena K
    v_arena: torch.Tensor,
    k_small: torch.Tensor,  # [e_delta + T, Hkv, hd] rotated delta rows ++ the T self rows
    v_small: torch.Tensor,
    visible_len: int,
    extra_visible: int,
    *,
    e_delta: int,
) -> torch.Tensor:
    """K2-verify. Returns [T, H, hd] in v_small's dtype: row t is query t
    over the arena, the delta rows below extra_visible and the self rows
    e_delta .. e_delta + t (on the card, K2 called with k_small[:e_delta +
    t + 1] to K2's tolerance: all T x G query rows of a kv head go through
    the tensor cores at once). T == 1 runs K2 itself (and counts as K2).
    One launch a call, on the host's split (`verify_split_size`)."""
    T, H, hd = q_rot.shape
    if k_small.shape[0] != e_delta + T or v_small.shape != k_small.shape:
        raise ValueError(f"k_small must hold e_delta ({e_delta}) + T ({T}) rows, got "
                         f"{k_small.shape[0]}")
    if T == 1:
        return streaming_decode_attention_full(q_rot[0], k_arena, v_arena, k_small, v_small,
                                               visible_len, extra_visible, e_delta=e_delta)[None]
    if q_rot.device.type == "cpu":
        return verify_attention_plain(q_rot, k_arena, v_arena, k_small, v_small, visible_len,
                                      extra_visible, e_delta=e_delta)
    name = "streaming_verify_attention"
    check_cuda(name, q_rot, k_arena, v_arena, k_small, v_small)
    if any(t.dtype != torch.bfloat16 for t in (q_rot, k_arena, v_arena, k_small, v_small)):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    from ._kernels import lib

    so = lib()
    C, Hkv = k_arena.shape[0], k_arena.shape[1]
    if (hd != 128 or H % Hkv or H // Hkv > 8 or v_arena.shape != k_arena.shape
            or k_small.shape[1:] != (Hkv, hd)):
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} "
                         f"arena={tuple(k_arena.shape)} k_small={tuple(k_small.shape)}")
    if T > so.verify_max_queries or e_delta + T > so.verify_max_small_rows:
        raise ValueError(f"{name}: T {T} (at most {so.verify_max_queries}) and e_delta + T "
                         f"{e_delta + T} (at most {so.verify_max_small_rows}) out of range")
    vis = int(visible_len)
    if not 0 <= vis <= C or not 0 <= int(extra_visible) <= e_delta:
        raise ValueError(f"{name}: visible_len {vis} / extra_visible {extra_visible} out of range")
    split = verify_split_size(vis, Hkv, sm_count(q_rot.device), so.verify_max_split)
    n_splits = -(-vis // split)
    if n_splits + 1 > so.verify_max_parts:
        raise ValueError(f"{name}: visible_len {vis} needs {n_splits} splits of {split}, more "
                         f"than the kernel's {so.verify_max_parts - 1}")
    # partials [Hkv, n_parts, T G(, hd)]: the scratch's rows of T heads
    part_m, part_l, part_acc, counters = _decode_scratch(q_rot.device, T, Hkv, n_splits + 1,
                                                         H // Hkv, hd)
    out = torch.empty(T, H, hd, dtype=v_small.dtype, device=q_rot.device)
    err = so.svt_verify_attention(
        ptr(q_rot), ptr(k_arena), ptr(v_arena), ptr(k_small), ptr(v_small), ptr(part_m),
        ptr(part_l), ptr(part_acc), ptr(counters), ptr(out), T, H, Hkv, hd, int(e_delta), vis,
        int(extra_visible), split, stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# K3: decode attention over the raw arena (int8 or bf16 storage form)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _mrope_freq_table(hd: int, mrope_section: Tuple[int, int, int], rope_theta: float,
                      device: torch.device) -> torch.Tensor:
    """[3, hd/2] f32 inverse frequencies masked per mRoPE axis: row a holds
    inv_freq[ch] where channel ch belongs to axis a, else 0, so that
    pos0*f0 + pos1*f1 + pos2*f2 is the one product pos[axis(ch)] * inv_freq[ch]
    (the JAX wrapper's table). Built once per device and geometry."""
    h2 = hd // 2
    inv = make_inv_freq(hd, rope_theta)
    s0, s1, _ = mrope_section
    ch = np.arange(h2)
    axis = np.where(ch < s0, 0, np.where(ch < s0 + s1, 1, 2))
    f = np.where(np.arange(3)[:, None] == axis[None, :], inv[None, :], 0.0).astype(np.float32)
    return torch.from_numpy(f).to(device)


def _raw_arena_rotated(k_q, k_s, v_q, v_s, pos_t, visible_len: int, cdt, *,
                       mrope_section: Tuple[int, int, int], rope_theta: float):
    """The visible raw arena slots as K3 reads them: dequantized to cdt,
    K rotated in f32 from the slots' positions and cast back. Returns
    (k_rot, v) [visible_len, Hkv, hd] in cdt."""
    vis = int(visible_len)
    if k_s is None:
        kf, vf = k_q[:vis].to(cdt), v_q[:vis].to(cdt)
    else:
        kf = dequantize_kv(QuantKV(k_q[:vis], k_s[:vis]), cdt)
        vf = dequantize_kv(QuantKV(v_q[:vis], v_s[:vis]), cdt)
    inv_freq = torch.from_numpy(make_inv_freq(k_q.shape[-1], rope_theta)).to(k_q.device)
    cos, sin = mrope_cos_sin(pos_t[:vis].T, inv_freq, mrope_section)
    return apply_rope(kf, cos[:, None, :], sin[:, None, :]), vf


def decode_attention_int8_plain(
    q_rot, k_q, k_s, v_q, v_s, pos_t, k_small, v_small, visible_len: int,
    extra_visible: int, *, e_delta: int, mrope_section: Tuple[int, int, int],
    rope_theta: float,
) -> torch.Tensor:
    """Plain version of K3 (and the JAX package's jnp route): dequantize the
    visible arena slots to the compute dtype (v_small's), rotate K in f32
    from the slots' positions and cast back, then K2's plain joint softmax.
    Returns [H, hd] in v_small's dtype."""
    k_rot, vf = _raw_arena_rotated(k_q, k_s, v_q, v_s, pos_t, visible_len, v_small.dtype,
                                   mrope_section=mrope_section, rope_theta=rope_theta)
    return decode_attention_plain(
        q_rot, k_rot, vf, k_small, v_small, int(visible_len), extra_visible, e_delta=e_delta
    )


def decode_attention_int8_by_splits(
    q_rot, k_q, k_s, v_q, v_s, pos_t, k_small, v_small, visible_len: int,
    extra_visible: int, *, e_delta: int, mrope_section: Tuple[int, int, int],
    rope_theta: float, split: int,
) -> torch.Tensor:
    """K3's schedule in plain PyTorch: each slot dequantized and rotated as
    `decode_attention_int8_plain` does, then K2's schedule (one log2-space
    partial per split of `decode_splits(visible_len, split)`, one for the
    small block, one merge). Returns [H, hd] in v_small's dtype; equal to
    the plain version up to f32 summation order."""
    k_rot, vf = _raw_arena_rotated(k_q, k_s, v_q, v_s, pos_t, visible_len, v_small.dtype,
                                   mrope_section=mrope_section, rope_theta=rope_theta)
    return decode_attention_by_splits(
        q_rot, k_rot, vf, k_small, v_small, int(visible_len), extra_visible, e_delta=e_delta,
        split=split,
    )


def decode_attention_int8_lanes_plain(
    q_rot, k_q, k_s, v_q, v_s, pos_t, k_small, v_small, visible_len, extra_visible: int, *,
    e_delta: int, mrope_section: Tuple[int, int, int], rope_theta: float,
) -> torch.Tensor:
    """Plain version of K3's lane form: `decode_attention_int8_plain` for
    each lane of [B, ...] inputs (visible_len: one length, B ints or a [B]
    tensor). Returns [B, H, hd] in v_small's dtype."""
    B = q_rot.shape[0]
    vis = lane_lengths(visible_len, B)
    return torch.stack([
        decode_attention_int8_plain(
            q_rot[b], k_q[b], None if k_s is None else k_s[b], v_q[b],
            None if v_s is None else v_s[b], pos_t[b], k_small[b], v_small[b], vis[b],
            extra_visible, e_delta=e_delta, mrope_section=mrope_section, rope_theta=rope_theta)
        for b in range(B)])


def streaming_decode_attention_int8(
    q_rot: torch.Tensor,  # [H, hd] rotated single-token queries (unscaled), or [B, H, hd]
    k_q: torch.Tensor,  # [C, Hkv, hd] RAW (un-rotated) arena K: int8, or bf16 ([B, ...])
    k_s: Optional[torch.Tensor],  # [C, Hkv] f32 scales ([B, C, Hkv]), or None (unquantized)
    v_q: torch.Tensor,  # [C, Hkv, hd] arena V, same representation
    v_s: Optional[torch.Tensor],
    pos_t: torch.Tensor,  # [C, 3] f32 per-slot mRoPE positions, or [B, C, 3]
    k_small: torch.Tensor,  # [e_delta + 1, Hkv, hd] ROTATED delta rows ++ self row ([B, ...])
    v_small: torch.Tensor,
    visible_len,  # int, or (lane form) an int32 [B] tensor on the card
    extra_visible: int,
    *,
    e_delta: int,
    mrope_section: Tuple[int, int, int],
    rope_theta: float,
    max_visible: Optional[int] = None,  # lane form: the largest of visible_len (host)
) -> torch.Tensor:
    """K3. Returns [H, hd] (lane form: [B, H, hd]) in v_small's dtype (the
    compute dtype the arena is dequantized to). Same no-padding contract for
    k_small as K2.

    On the card, one launch (counted once): the host picks the split
    (`decode_split_size`, from max_visible for the lane form), the grid is
    (splits + the small block, kv heads, lanes), and the last CTA of each
    (lane, kv head) folds the partials (scratch and counters from
    `_decode_scratch`, shared with K2 and K4). Its plain schedule is
    `decode_attention_int8_by_splits`. The arenas and scales may be
    lane-strided views (a layer of a [B, L, C, ...] arena)."""
    if (k_s is None) != (v_s is None):
        raise ValueError("pass scales for both K and V, or for neither")
    if sum(mrope_section) != q_rot.shape[-1] // 2:
        raise ValueError(f"mrope_section {mrope_section} must sum to head_dim / 2")
    kw = dict(e_delta=e_delta, mrope_section=mrope_section, rope_theta=rope_theta)
    if q_rot.dim() == 2:  # one stream: the lane form at B = 1
        return streaming_decode_attention_int8(
            q_rot[None], k_q[None], _lead(k_s), v_q[None], _lead(v_s), pos_t[None],
            k_small[None], v_small[None], int(visible_len), extra_visible, **kw)[0]
    B, H, hd = q_rot.shape
    E1 = k_small.shape[1]
    if E1 <= e_delta or v_small.shape != k_small.shape:
        raise ValueError(f"no-padding contract: k_small rows {E1} must exceed e_delta {e_delta}")
    if q_rot.device.type == "cpu":
        return decode_attention_int8_lanes_plain(
            q_rot, k_q, k_s, v_q, v_s, pos_t, k_small, v_small, visible_len, extra_visible, **kw)
    name = "streaming_decode_attention_int8"
    C, Hkv = k_q.shape[1], k_q.shape[2]
    quantized = k_s is not None
    store = torch.int8 if quantized else torch.bfloat16
    check_cuda(name, q_rot, pos_t, k_small, v_small)
    kq_lane = _check_lanes(name, k_q, (B, C, Hkv, hd))
    vq_lane = _check_lanes(name, v_q, (B, C, Hkv, hd))
    if (q_rot.dtype, k_small.dtype, v_small.dtype) != (torch.bfloat16,) * 3:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q and k_small/v_small")
    if k_q.dtype != store or v_q.dtype != store:
        raise ValueError(f"{name}: arena K/V must both be {store} [B, C, Hkv, hd]")
    if pos_t.dtype != torch.float32 or pos_t.shape != (B, C, 3):
        raise ValueError(f"{name}: pos_t must be f32 [B, C, 3]")
    s_lane = 0
    if quantized:
        s_lane = _check_lanes(name, k_s, (B, C, Hkv))
        if _check_lanes(name, v_s, (B, C, Hkv)) != s_lane or k_s.dtype != torch.float32 \
                or v_s.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be f32 [B, C, Hkv], K's and V's lanes alike")
    from ._kernels import lib

    so = lib()
    if hd != 128 or H % Hkv or H // Hkv > 8 or Hkv > 8:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} arena={tuple(k_q.shape)}")
    if k_small.shape[2:] != (Hkv, hd) or k_small.shape[0] != B or E1 > so.decode_max_small_rows:
        raise ValueError(f"{name}: k_small must be [B, <= {so.decode_max_small_rows}, Hkv, hd]")
    vis_dev, vis_max = _decode_lengths(name, visible_len, max_visible, B, q_rot.device)
    if not 0 <= vis_max <= C or not 0 <= int(extra_visible) <= e_delta:
        raise ValueError(f"{name}: visible_len {vis_max} / extra_visible {extra_visible} out of range")
    freqs = _mrope_freq_table(hd, tuple(mrope_section), float(rope_theta), q_rot.device)
    split, n_splits = _decode_parts(name, vis_max, Hkv, q_rot.device, so.raw_decode_max_split,
                                    so.raw_decode_max_parts, B)
    part_m, part_l, part_acc, counters = _decode_scratch(q_rot.device, B, Hkv, n_splits + 1,
                                                         H // Hkv, hd)
    out = torch.empty(B, H, hd, dtype=v_small.dtype, device=q_rot.device)
    err = so.svt_decode_attention_raw(
        ptr(q_rot), ptr(k_q), ptr(k_s), ptr(v_q), ptr(v_s), ptr(pos_t), ptr(freqs),
        ptr(k_small), ptr(v_small), ptr(part_m), ptr(part_l), ptr(part_acc), ptr(counters),
        ptr(out), ptr(vis_dev), B, H, Hkv, hd, C, E1, int(e_delta), vis_max, int(extra_visible),
        split, int(quantized), kq_lane, vq_lane, s_lane, stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# K4: the arena's softmax partials of one token, and their merge
# ---------------------------------------------------------------------------


def decode_attention_partials_plain(q_rot, k_arena, v_arena, visible_len: int):
    """Plain version of K4: f32 log2-space online-softmax partials of one
    token over arena slots < visible_len. Returns (m [H], l [H], acc [H,
    hd]), unnormalised; at visible_len == 0, m = -1e30, l = 0, acc = 0."""
    H, hd = q_rot.shape
    Hkv = k_arena.shape[1]
    G = H // Hkv
    vis = int(visible_len)
    if vis == 0:
        z = torch.zeros(H, dtype=torch.float32, device=q_rot.device)
        return z + NEG_INF, z, torch.zeros(H, hd, dtype=torch.float32, device=q_rot.device)
    qg = q_rot.float().reshape(Hkv, G, hd) * (LOG2E / math.sqrt(hd))
    lg = torch.einsum("kgd,skd->kgs", qg, k_arena[:vis].float())
    m = lg.amax(dim=-1)
    p = torch.exp2(lg - m[..., None])
    acc = torch.einsum("kgs,skd->kgd", p, v_arena[:vis].float())
    return m.reshape(H), p.sum(dim=-1).reshape(H), acc.reshape(H, hd)


def streaming_decode_attention(
    q_rot: torch.Tensor,  # [H, hd] rotated single-token queries (unscaled)
    k_arena: torch.Tensor,  # [C, Hkv, hd] PRE-ROTATED arena K
    v_arena: torch.Tensor,
    visible_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4. Returns the log2-space partials (m [H], l [H], acc [H, hd]), f32."""
    if q_rot.device.type == "cpu":
        return decode_attention_partials_plain(q_rot, k_arena, v_arena, visible_len)
    name = "streaming_decode_attention"
    H, hd = q_rot.shape
    C, Hkv, _ = k_arena.shape
    check_cuda(name, q_rot, k_arena, v_arena)
    if any(t.dtype != torch.bfloat16 for t in (q_rot, k_arena, v_arena)):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v")
    if hd != 128 or H % Hkv or H // Hkv > 8 or v_arena.shape != k_arena.shape:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q_rot.shape)} arena={tuple(k_arena.shape)}")
    if not 0 <= int(visible_len) <= C:
        raise ValueError(f"{name}: visible_len {visible_len} outside [0, {C}]")
    from ._kernels import lib

    so = lib()
    split, n_parts = _decode_parts(name, int(visible_len), Hkv, q_rot.device,
                                   so.decode_max_split, so.decode_max_parts)
    part_m, part_l, part_acc, counters = _decode_scratch(q_rot.device, 1, Hkv, n_parts, H // Hkv,
                                                         hd)
    m = torch.empty(H, dtype=torch.float32, device=q_rot.device)
    l = torch.empty_like(m)
    acc = torch.empty(H, hd, dtype=torch.float32, device=q_rot.device)
    err = so.svt_decode_partials(
        ptr(q_rot), ptr(k_arena), ptr(v_arena), ptr(part_m), ptr(part_l), ptr(part_acc),
        ptr(counters), ptr(m), ptr(l), ptr(acc), H, Hkv, hd, int(visible_len), split, stream(),
    )
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return m, l, acc


def decode_attention_merge(
    q: torch.Tensor,  # [1, H, hd] rotated (unscaled)
    small_parts,  # list of (k [S, Hkv, hd] rotated, v, mask [1, S]), tiny
    ak: torch.Tensor,  # [C, Hkv, hd] pre-rotated arena K
    av: torch.Tensor,
    visible_len: int,
) -> torch.Tensor:
    """Decode attention as K4's arena partials merged in log2 space with an
    exact f32 softmax over the small parts (decode delta + the token
    itself). Port of the JAX package's `_decode_attention_merge`
    (models/qwen25_vl/language.py); equal to one softmax over the
    concatenated keys. Returns [1, H * hd] in av's dtype."""
    _, H, hd = q.shape
    Hkv = ak.shape[1]
    G = H // Hkv
    m_a, l_a, acc_a = streaming_decode_attention(q[0], ak, av, visible_len)
    ks = torch.cat([k for k, _, _ in small_parts], dim=0).float()
    vs = torch.cat([v for _, v, _ in small_parts], dim=0).float()
    msk = torch.cat([m[0] for _, _, m in small_parts], dim=0)
    lg = torch.einsum("kgd,skd->kgs", q.float().reshape(Hkv, G, hd), ks) * (LOG2E / math.sqrt(hd))
    lg = lg.masked_fill(~msk[None, None, :], NEG_INF)
    m_b = lg.amax(dim=-1).reshape(H)
    p = torch.exp2(lg - m_b.reshape(Hkv, G, 1))
    l_b = p.sum(dim=-1).reshape(H)
    acc_b = torch.einsum("kgs,skd->kgd", p, vs).reshape(H, hd)
    m_ab = torch.maximum(m_a, m_b)
    wa = torch.exp2(m_a - m_ab)
    wb = torch.exp2(m_b - m_ab)
    acc = acc_a * wa[:, None] + acc_b * wb[:, None]
    out = acc / (l_a * wa + l_b * wb).clamp_min(1e-20)[:, None]
    return out.reshape(1, H * hd).to(av.dtype)
