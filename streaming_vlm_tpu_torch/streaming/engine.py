"""Streaming engine: chunk prefill + decode over the KV arena, in PyTorch.

Port of streaming_vlm_tpu/streaming/engine.py. The arena is float
(`kv_quant="none"`) or int8 with per-(slot, head) scales
(`kv_quant="int8"`), and K is either rotated once per chunk into a copy
(`StreamConfig.effective_prerotate`; stored in the compute dtype, or
requantized to int8 with `rot_quant="int8"`) or read raw and rotated at
attention time. `chunk_step_batched` does what the JAX package's jitted
(vmapped) step does, for B independent streams in one pass, as eager
launches:

  [pre-rotated: dequantize + rotate every lane's arena K once for the
  chunk's positions, layer by layer (requantized for rot_quant="int8")] ->
  embed + vision-embed scatter -> chunk prefill (kernel K1's lane form,
  pre-rotated or raw mode) -> a `max_new`-step decode loop (K2's lane form
  over the rotated copy, or K3's over the raw arena; repetition-penalty
  sampling, each lane from its own generator) -> merge the new K/V
  (quantized per slot into an int8 arena).

Every projection runs once over all lanes' rows, so each weight is read
once per step for the B streams. The lanes' lengths and budgets reach the
device in one upload per step call; the decode kernels read the lengths
there. `chunk_step` (one stream) is the same body at B = 1.

The host engine (`StreamingEngine`) also carries the JAX engine's serving
surface: `prewarm` (every step the stream will hit, run once on dummy
inputs before chunk 0), recompute mode (`mark_all_uncached`: the whole
table re-prefills with the chunk), uint8 frames uploaded and patchified on
the device (`upload_frames`, `frames_u8=`), and the eos threshold gate
(`ChunkStatics.eos_threshold`).

The arenas are updated IN PLACE (the JAX package donates them instead);
eviction gathers into fresh tensors, never in place. The decode loop
always runs `max_new` steps and keeps every token on the device (tokens
after `done` are eos, n_gen = sum(~was_done)), so a chunk (or a round)
needs one host sync, in `finish_chunk` (`MultiStreamEngine.finish_round`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, SamplingConfig, StreamConfig
from ..models.qwen25_vl import language, model as vlm
from ..models.qwen25_vl.rope import (
    PosSegment,
    apply_rope,
    mrope_cos_sin,
    mrope_positions_from_segments,
)
from ..ops.quant import (
    Arena,
    QuantKV,
    as_float,
    compute_dtype,
    gather_slots,
    gather_slots_lanes,
    lanes_layer,
    quantize_kv,
    with_lanes,
    write_slots_lanes,
)
from ..ops.attention import reserve_decode_scratch
from ..ops.sampling import sample_tokens
from ..utils.buckets import bucket_for
from .segments import ASST_BODY, ASST_TAIL, Seg, SegmentTable

# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------


def positions_from_descriptors(desc: Dict[str, torch.Tensor], capacity: int) -> torch.Tensor:
    """Rebuild the [3, C] mRoPE position tensor on the device from the
    segment descriptor table (SegmentTable.position_descriptors), or [B, 3,
    C] from B lanes' tables stacked as [B, max_segs] (unused rows padded
    with starts 2**30). Slots past the last real segment get garbage
    positions but are invisible."""
    lanes = desc["starts"].dim() == 2
    d = desc if lanes else {k: v[None] for k, v in desc.items()}
    starts = d["starts"].long()
    B = starts.shape[0]
    slot = torch.arange(capacity, dtype=torch.long, device=starts.device).expand(B, capacity)
    sid = (torch.searchsorted(starts, slot.contiguous(), right=True) - 1).clamp_min(0)

    def at(k):
        return torch.gather(d[k], 1, sid)

    off = slot - torch.gather(starts, 1, sid)
    gh, gw = at("ghs").long(), at("gws").long()
    is_vid = at("kinds") == 1
    offf = off.float()
    t = torch.where(is_vid, torch.div(off, gh * gw, rounding_mode="floor").float() * at("tsteps"), offf)
    h = torch.where(is_vid, (torch.div(off, gw, rounding_mode="floor") % gh).float(), offf)
    w = torch.where(is_vid, (off % gw).float(), offf)
    pos = at("bases")[:, None, :] + torch.stack([t, h, w], dim=1)
    return pos if lanes else pos[0]


def compact_arena(k_arena, v_arena, ids_arena, src_idx: torch.Tensor):
    """new[:, i] = old[:, src_idx[i]], gathered into fresh tensors."""
    return (
        gather_slots(k_arena, src_idx),
        gather_slots(v_arena, src_idx),
        ids_arena.index_select(0, src_idx),
    )


def compact_arena_batched(k_arena, v_arena, ids_arena, src_idx: torch.Tensor):
    """Per-lane gathers for the multi-stream engine: new[b, :, i] =
    old[b, :, src_idx[b, i]] over [B, L, C, Hkv, hd] arenas (float or
    QuantKV) and ids [B, C], src_idx [B, C] (identity rows for lanes that
    did not evict), into fresh tensors, one gather per leaf."""
    return (
        gather_slots_lanes(k_arena, src_idx),
        gather_slots_lanes(v_arena, src_idx),
        torch.gather(ids_arena, 1, src_idx),
    )


@dataclasses.dataclass
class ChunkHandle:
    """In-flight chunk: device results + the host state finish_chunk needs."""

    gen: Any  # [max_new] int64 on the device (a lane's row, filled in by finish_round)
    n_gen: Any  # 0-d int64 on the device (or a host int)
    n_real: int
    next_p: float  # append-mode next position base
    eos: int
    gen_cm: Any  # open GEN timer section (or nullcontext)


@dataclasses.dataclass(frozen=True)
class ChunkStatics:
    """Per-chunk constants of chunk_step."""

    cfg: ModelConfig
    t_pad: int  # padded chunk length (a prefill bucket)
    max_new: int
    temperature: float
    repetition_penalty: float
    do_sample: bool
    # threshold gate on a streaming-eos token, (token_id, base, step): the
    # token is suppressed while its softmax probability <= base + step *
    # decode_step (LiveCC's ' ...' gate)
    eos_threshold: Optional[Tuple[int, float, float]] = None
    # positions arrive as a descriptor table (shrink mode) instead of [3, C]
    use_descriptors: bool = False
    # rotate the arena K once per chunk into a copy (K1 pre-rotated, K2) vs
    # rotate at attention time from per-slot positions (K1 raw, K3)
    prerotate: bool = True
    # "int8": the rotated copy is requantized (StreamConfig.rot_quant)
    rot_quant: str = "none"


def _lane_ints(values, dev) -> Tuple[List[int], torch.Tensor]:
    """(host ints, the same [n, B] int64 on the device in one copy)."""
    host = [[int(x) for x in v] for v in values]
    t = torch.tensor(host, dtype=torch.int64)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return host, t


def _eos_gate(logits: torch.Tensor, eos_threshold: Tuple[int, float, float], step: int):
    """Suppress the gated token (logit -inf) in every lane where its softmax
    probability over the f32 logits [B, V] is <= base + step * step_size.
    The threshold is f32(step_size) * step + f32(base) rounded once, as the
    JAX package's jitted gate computes it (one FMA on XLA's CPU backend)."""
    tok_id, base, step_sz = eos_threshold
    thr = float(np.float32(float(np.float32(step_sz)) * step + float(np.float32(base))))
    prob = torch.softmax(logits, dim=-1)[:, tok_id]
    out = logits.clone()
    out[:, tok_id] = torch.where(prob <= thr, float("-inf"), logits[:, tok_id])
    return out


def _merge_vision_lanes(embeds: torch.Tensor, vis_embeds: torch.Tensor, vis_slots) -> None:
    """Scatter lane b's vision rows vis_embeds[b, j] into its chunk row
    vis_slots[b, j] of embeds [B, T, D], in place; slots >= T are dropped
    (the JAX scatter's mode="drop": idle and text-only lanes pass T). The
    slots are host ints, so the kept rows are chosen on the host."""
    B, T, D = embeds.shape
    slots = np.asarray(vis_slots).reshape(B, -1)
    N = slots.shape[1]
    b, j = np.nonzero(slots < T)
    if not len(b):
        return
    idx = torch.from_numpy(np.stack([b * T + slots[b, j], b * N + j]).astype(np.int64))
    idx = idx.to(embeds.device, non_blocking=True)
    rows = vis_embeds.reshape(B * N, D).index_select(0, idx[1]).to(embeds.dtype)
    embeds.view(B * T, D).index_copy_(0, idx[0], rows)


def rotated_copy(tcfg, lm, k_arena: Arena, slot_positions: torch.Tensor, adt: torch.dtype,
                 rot_quant: str = "none") -> Arena:
    """Every lane's arena K ([B, L, C, Hkv, hd], float or QuantKV) rotated
    once for the chunk's (fixed) positions [B, 3, C] (an int8 arena is
    dequantized in the same pass), layer by layer so that the transients
    are one [B, C, Hkv, hd] layer: the prefill and every decode step read
    this copy; the raw arena is what persists across chunks. In `adt`, or
    with rot_quant="int8" requantized per (slot, head) (the raw int8
    arena's bytes; read through a per-layer dequant, derived fresh each
    chunk): quantize_kv(apply_rope(dequantize_kv(k_l))), as the JAX
    engine's rot_layer."""
    B, L, C, Hkv, hd = k_arena.q.shape if isinstance(k_arena, QuantKV) else k_arena.shape
    dev = slot_positions.device
    a_cos, a_sin = mrope_cos_sin(slot_positions.transpose(0, 1).reshape(3, B * C),
                                 lm.inv_freq(dev), tcfg.mrope_section)
    a_cos, a_sin = a_cos.view(B, C, 1, hd // 2), a_sin.view(B, C, 1, hd // 2)
    if rot_quant == "int8":
        k_rot = QuantKV(torch.empty(B, L, C, Hkv, hd, dtype=torch.int8, device=dev),
                        torch.empty(B, L, C, Hkv, dtype=torch.float32, device=dev))
    else:
        k_rot = torch.empty(B, L, C, Hkv, hd, dtype=adt, device=dev)
    for l in range(L):
        kr = apply_rope(as_float(lanes_layer(k_arena, l), adt), a_cos, a_sin)
        if rot_quant == "int8":
            kq = quantize_kv(kr)
            k_rot.q[:, l], k_rot.s[:, l] = kq.q, kq.s
        else:
            k_rot[:, l] = kr
    return k_rot


class Prefill(NamedTuple):
    """What a chunk prefill hands the decode that follows it."""

    slot_positions: torch.Tensor  # [B, 3, C] f32 (descriptors resolved)
    k_rot: Optional[Arena]  # the rotated K copy the decode reads (pre-rotated mode)
    arena_kw: Dict[str, Any]  # the arena arguments of language_forward_lanes
    presence: torch.Tensor  # [B, V] bool: the ids of every visible slot
    logits: torch.Tensor  # [B, V] f32 at each lane's last real chunk row


def prefill_lanes(
    cfg: ModelConfig,
    model: vlm.Qwen25VL,
    k_arena: Arena,
    v_arena: Arena,
    slot_positions,
    tokens: torch.Tensor,
    vis_embeds: Optional[torch.Tensor],
    vis_slots,
    ids_arena: torch.Tensor,
    insert_at: Sequence[int],
    ins_d: torch.Tensor,  # insert_at, n_real and their sum as [B] int64 on the device
    nreal_d: torch.Tensor,
    base_d: torch.Tensor,
    *,
    t_pad: int,
    use_descriptors: bool,
    prerotate: bool,
    rot_quant: str,
) -> Prefill:
    """The prefill phase of a chunk step for B lanes (`chunk_step_batched`'s
    and `specdecode.spec_prefill_step`'s): the rotated K copy (pre-rotated
    mode), the chunk's ids into the ids arena and the repetition-penalty
    presence mask, embeddings with the vision rows scattered in, one
    streaming forward (K1), the block's K/V merged into the arenas, and the
    logits at each lane's last real row."""
    tcfg = cfg.text
    lm = model.text
    B, C = ids_arena.shape
    dev = ids_arena.device
    adt = compute_dtype(k_arena, lm.embed.weight.dtype)
    if use_descriptors:
        slot_positions = positions_from_descriptors(slot_positions, C)

    k_rot = None
    if prerotate:
        k_rot = rotated_copy(tcfg, lm, k_arena, slot_positions, adt, rot_quant)
        arena_kw = dict(arena=(k_rot, v_arena), arena_rotated=True)
    else:
        # the raw arena is read in its storage form; K1 and K3 rotate it
        arena_kw = dict(arena=(k_arena, v_arena), arena_positions=slot_positions)

    # chunk token ids, then the repetition-penalty presence mask (column V
    # takes the ids of invisible slots, dropped)
    V = tcfg.vocab_size
    cols = ins_d[:, None] + torch.arange(t_pad, device=dev)
    ids_arena.scatter_(1, cols, tokens)
    valid = torch.arange(C, device=dev)[None, :] < base_d[:, None]
    presence = torch.zeros(B, V + 1, dtype=torch.bool, device=dev)
    presence.scatter_(1, torch.where(valid, ids_arena, V), True)
    presence = presence[:, :V]

    embeds = language.embed_tokens(tcfg, lm, tokens)
    if vis_embeds is not None:
        _merge_vision_lanes(embeds, vis_embeds, vis_slots)

    q_pos = torch.gather(slot_positions, 2, cols[:, None, :].expand(B, 3, t_pad))
    hidden, (k_block, k_block_rot, v_block) = language.language_forward_lanes(
        tcfg, lm, embeds, q_pos, visible_len=insert_at, **arena_kw
    )
    write_slots_lanes(k_arena, k_block, insert_at)
    if prerotate:
        write_slots_lanes(k_rot, k_block_rot, insert_at)
    write_slots_lanes(v_arena, v_block, insert_at)
    logits = language.lm_logits(tcfg, lm, hidden[torch.arange(B, device=dev), nreal_d - 1])
    return Prefill(slot_positions, k_rot, arena_kw, presence, logits)


@torch.no_grad()
def chunk_step_batched(
    statics: ChunkStatics,
    model: vlm.Qwen25VL,
    k_arena: Arena,  # [B, L, C, Hkv, hd] (float or QuantKV), updated in place
    v_arena: Arena,
    slot_positions,  # [B, 3, C] f32, or the descriptor dict of [B, max_segs] device tensors
    tokens: torch.Tensor,  # [B, t_pad] int64 on the device (padded)
    vis_embeds: Optional[torch.Tensor],  # [B, N_vis, D] on the device, or None
    vis_slots,  # [B, N_vis] host ints: rows within each lane's chunk (>= t_pad: dropped)
    ids_arena: torch.Tensor,  # [B, C] int64, updated in place
    insert_at: Sequence[int],  # [B] host ints: first arena slot of each lane's chunk
    n_real: Sequence[int],  # [B] real (unpadded) chunk lengths
    eos_id: Sequence[int],  # [B]
    n_max: Sequence[int],  # [B] decode budgets <= statics.max_new
    generators: Sequence[Optional[torch.Generator]],  # [B]; None: the lane draws no noise
):
    """B streams' chunk steps in one pass over shared weights. Each lane's
    results are those of `chunk_step` on that lane alone: per-lane
    positions, insert points, lengths, eos and budgets (a lane stops
    emitting at its own n_max, as at a natural eos; the loop runs
    statics.max_new steps for all). Returns (gen [B, max_new] int64, n_gen
    [B] int64), both on the device."""
    cfg = statics.cfg
    tcfg = cfg.text
    lm = model.text
    B, C = ids_arena.shape
    dev = ids_arena.device
    L, Hkv, hd = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim
    # compute dtype of the K/V blocks and the decode delta
    adt = compute_dtype(k_arena, lm.embed.weight.dtype)
    (insert_at, n_real, _, _), lanes = _lane_ints((insert_at, n_real, eos_id, n_max), dev)
    ins_d, nreal_d, eos_d, nmax_d = lanes
    decode_base = [a + n for a, n in zip(insert_at, n_real)]
    base_d = ins_d + nreal_d
    pre = prefill_lanes(
        cfg, model, k_arena, v_arena, slot_positions, tokens, vis_embeds, vis_slots, ids_arena,
        insert_at, ins_d, nreal_d, base_d, t_pad=statics.t_pad,
        use_descriptors=statics.use_descriptors, prerotate=statics.prerotate,
        rot_quant=statics.rot_quant,
    )
    slot_positions, arena_kw, presence, logits = (pre.slot_positions, pre.arena_kw,
                                                  pre.presence, pre.logits)

    max_new = statics.max_new
    dcols = base_d[:, None] + torch.arange(max_new, device=dev)
    delta_pos = torch.gather(slot_positions, 2, dcols[:, None, :].expand(B, 3, max_new))
    # the decode kernels' per-lane lengths, on the device; the largest on the host
    vis_decode = base_d.to(torch.int32)
    dk = torch.zeros(B, L, max_new, Hkv, hd, dtype=adt, device=dev)
    dkr = torch.zeros_like(dk)
    dv = torch.zeros_like(dk)
    gen = torch.empty(B, max_new, dtype=torch.long, device=dev)
    was_done = torch.empty(B, max_new, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(max_new):
        if statics.eos_threshold is not None:
            logits = _eos_gate(logits, statics.eos_threshold, step)
        tok = sample_tokens(
            generators, logits, presence,
            temperature=statics.temperature,
            repetition_penalty=statics.repetition_penalty,
            do_sample=statics.do_sample,
        )
        tok = torch.where(done, eos_d, tok)
        presence.scatter_(1, tok[:, None], True)
        gen[:, step] = tok
        was_done[:, step] = done
        # a lane is done at its own budget exactly like a natural eos
        done = done | (tok == eos_d) | (step + 1 >= nmax_d)

        emb = language.embed_tokens(tcfg, lm, tok[:, None])
        hidden, (k1, k1_rot, v1) = language.language_forward_lanes(
            tcfg, lm, emb, delta_pos[:, :, step : step + 1], visible_len=vis_decode,
            max_visible=max(decode_base), extra=(dkr, dv), extra_visible=step, **arena_kw,
        )
        dk[:, :, step] = k1[:, :, 0]
        dkr[:, :, step] = k1_rot[:, :, 0]
        dv[:, :, step] = v1[:, :, 0]
        logits = language.lm_logits(tcfg, lm, hidden[:, 0])

    write_slots_lanes(k_arena, dk, decode_base)
    write_slots_lanes(v_arena, dv, decode_base)
    ids_arena.scatter_(1, dcols, gen)
    return gen, (~was_done).sum(dim=1)


def chunk_step(
    statics: ChunkStatics,
    model: vlm.Qwen25VL,
    k_arena: Arena,  # [L, C, Hkv, hd] (float or QuantKV), updated in place
    v_arena: Arena,
    slot_positions,  # [3, C] f32, or the descriptor dict of device tensors
    tokens: torch.Tensor,  # [t_pad] int64 on the device (padded)
    vis_embeds: Optional[torch.Tensor],  # [N_vis, D] or None
    vis_slots,  # [N_vis] host ints: rows within the chunk
    ids_arena: torch.Tensor,  # [C] int64, updated in place
    insert_at: int,  # first arena slot of the chunk's tokens
    n_real: int,  # real (unpadded) chunk length
    eos_id: int,
    n_max: int,  # decode budget <= statics.max_new
    generator: Optional[torch.Generator],
):
    """One stream's chunk step: `chunk_step_batched` at B = 1. Returns (gen
    [max_new] int64, n_gen 0-d int64), both on the device."""
    pos = ({k: v[None] for k, v in slot_positions.items()} if statics.use_descriptors
           else slot_positions[None])
    gen, n_gen = chunk_step_batched(
        statics, model, with_lanes(k_arena), with_lanes(v_arena), pos, tokens[None],
        None if vis_embeds is None else vis_embeds[None],
        None if vis_slots is None else np.asarray(vis_slots)[None],
        ids_arena[None], [insert_at], [n_real], [eos_id], [n_max], [generator],
    )
    return gen[0], n_gen[0]


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------


def _bucket(n: int, buckets) -> int:
    return bucket_for(
        n, buckets, what="chunk",
        fix=f" Fix: add a bucket >= {n} to StreamConfig.prefill_buckets, or split the chunk.",
    )


class StreamingEngine:
    """Owns the device arena + host segment table; one `process_chunk` per
    second of video. Port of the JAX `StreamingEngine` (single stream)."""

    def __init__(
        self,
        cfg: ModelConfig,
        model: vlm.Qwen25VL,
        stream: StreamConfig,
        sampling: SamplingConfig,
        dtype: torch.dtype = torch.bfloat16,
        allocate_arena: bool = True,  # False: the arena is owned elsewhere (a multi-stream lane)
    ):
        if stream.kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got {stream.kv_quant!r}")
        if stream.rot_quant not in ("none", "int8"):
            raise ValueError(f"rot_quant must be 'none' or 'int8', got {stream.rot_quant!r}")
        if stream.decode_int8_kernel is False:
            raise ValueError(
                "decode_int8_kernel=False (the JAX package's jnp decode route) is not "
                "offered: the port decodes a raw arena through kernel K3 only. Fix: leave "
                "StreamConfig.decode_int8_kernel at None."
            )
        self.cfg = cfg
        self.model = model
        self.stream = stream
        self.sampling = sampling
        self.dtype = dtype
        self.device = model.text.embed.weight.device
        self.table = SegmentTable(all_text=stream.all_text)
        C = stream.kv_capacity
        if allocate_arena:
            self._check_memory_budget()
            self.k_arena, self.v_arena = language.init_kv_arena(
                cfg.text, C, dtype, self.device, quant=stream.kv_quant
            )
            self.ids_arena = torch.zeros(C, dtype=torch.long, device=self.device)
            t = cfg.text
            reserve_decode_scratch(self.device, 1, t.num_key_value_heads, C,
                                   t.num_attention_heads // t.num_key_value_heads, t.head_dim)
        else:
            # MultiStreamEngine owns the stacked [B, ...] arenas; this
            # engine keeps only host accounting (table, positions)
            self.k_arena = self.v_arena = self.ids_arena = None
        self.cached = 0  # arena slots holding valid KV (table prefix)
        # the last eviction's effect on `cached` (observability)
        self.cached_before_evict = 0
        self.cached_after_evict = 0
        # append mode: per-slot positions are assigned once, never re-indexed
        self._pos_host = np.zeros((3, C), np.float32)
        self._next_pos = 0.0
        # trailing table tokens whose KV is NOT yet in the arena (e.g. the
        # force-appended <|im_end|>); they prefill with the next chunk
        self.uncached_tail = 0
        self.chunk_index = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(sampling.seed)
        self._inflight: Optional[ChunkHandle] = None
        # a list: process_chunk_spec records each emitted token's [top-two
        # gap of the penalised logits, max |logit|] there (nan for the first
        # token, sampled by the prefill); None: nothing recorded
        self.spec_gaps: Optional[List[Tuple[float, float]]] = None

    # -------------------------------------------------------------- plumbing
    def _check_memory_budget(self) -> None:
        """Fail BEFORE allocating if the K/V arenas and the per-chunk
        rotated K copy do not fit the card's free memory (10% headroom for
        prefill/decode transients, each at most one [C, Hkv, hd] layer: the
        rotated copy is built and an int8 arena dequantized layer by layer).
        An int8 arena costs 1 + 4/hd bytes per element (data + f32
        per-(slot, head) scales), and so does a rotated copy with
        rot_quant="int8"; a raw arena has no rotated copy. No check on the
        CPU."""
        if self.device.type != "cuda":
            return
        t = self.cfg.text
        st = self.stream
        C = st.kv_capacity
        item = torch.empty((), dtype=self.dtype).element_size()
        kv_elems = t.num_hidden_layers * C * t.num_key_value_heads * t.head_dim
        if st.kv_quant == "int8":
            arena = 2 * int(kv_elems * (1 + 4.0 / t.head_dim))
        else:
            arena = 2 * kv_elems * item
        if not st.effective_prerotate:
            rot = 0
        elif st.rot_quant == "int8":
            rot = int(kv_elems * (1 + 4.0 / t.head_dim))
        else:
            rot = kv_elems * item
        need = int((arena + rot) * 1.1)
        free, _ = torch.cuda.mem_get_info(self.device)
        if need > free:
            gb = 2**30
            max_c = int(free / 1.1 / ((arena + rot) / C) // 512 * 512)
            raise ValueError(
                f"device memory exceeded before streaming: KV arena {arena / gb:.2f} GiB"
                + (f" + rotated copy {rot / gb:.2f} GiB" if rot else "")
                + f" > free {free / gb:.2f} GiB. Fix: lower kv_capacity to <= {max_c}, "
                f"or set StreamConfig.kv_quant='int8' to halve the arena, or "
                f"prerotate_arena=False to drop the rotated copy, or shorten the "
                f"window so fewer tokens survive eviction."
            )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _positions(self) -> np.ndarray:
        return self.table.positions(
            spatial_merge_size=self.cfg.vision.spatial_merge_size,
            tokens_per_second=self.cfg.vision.tokens_per_second,
        )

    # -------------------------------------------------------------- eviction
    def evict_plan(self):
        """Apply this round's eviction policy to the segment table and
        return the arena gather plan (host accounting only)."""
        plan = self.table.evict(
            self.chunk_index,
            text_round=self.stream.text_round,
            visual_round=self.stream.visual_round,
            text_sink=self.stream.text_sink,
            text_sliding_window=self.stream.text_sliding_window,
        )
        new_len = int(plan.src.shape[0])
        if plan.changed and self.stream.pos_mode == "append":
            self._pos_host[:, :new_len] = self._pos_host[:, plan.src]
        if self.uncached_tail and plan.changed:
            # a pruned uncached token has no KV to drop, but the tail count
            # must shrink with it (see the JAX engine for the invariant)
            src = np.asarray(plan.src)
            tail_mask = src >= self.cached
            new_tail = int(tail_mask.sum())
            if new_tail and not bool(tail_mask[new_len - new_tail :].all()):
                raise RuntimeError(
                    "eviction relocated uncached tokens away from the table end; "
                    "re-prefill cannot express a mid-table uncached token (raise "
                    "text_round or commit before evicting)"
                )
            self.uncached_tail = new_tail
        self.cached_before_evict = self.cached
        self.cached = new_len - self.uncached_tail
        self.cached_after_evict = self.cached
        return plan

    def evict(self) -> None:
        """Apply this round's eviction policy and compact the arena."""
        plan = self.evict_plan()
        if plan.changed:
            src = np.zeros(self.stream.kv_capacity, np.int64)
            src[: plan.src.shape[0]] = plan.src
            self.k_arena, self.v_arena, self.ids_arena = compact_arena(
                self.k_arena, self.v_arena, self.ids_arena,
                torch.from_numpy(src).to(self.device),
            )

    def mark_all_uncached(self) -> None:
        """Invalidate the whole cache: every table token re-prefills with the
        next chunk (recompute mode, efficiency config (c))."""
        self.uncached_tail = self.table.total_len()
        self.cached = 0

    def upload_frames(self, frames_u8: np.ndarray) -> torch.Tensor:
        """Start the copy of a chunk's uint8 frames to the engine's device
        (from a pinned host buffer, asynchronous on the card): call it for
        chunk i+1 before chunk i's step so that the copy overlaps the work.
        A CPU tensor only when the engine is on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(frames_u8, np.uint8))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def prewarm(
        self,
        grids: Tuple[Tuple[int, int, int], ...] = (),
        *,
        max_new_list: Optional[Tuple[int, ...]] = None,
        buckets: Optional[Tuple[int, ...]] = None,
        vision: str = "none",  # {"none", "frames", "patches", "both"}
        include_no_vision: bool = False,
        eos_threshold: Optional[Tuple[int, float, float]] = None,
    ) -> int:
        """Run, before the first chunk, every step the stream is configured
        to hit, so that no chunk (chunk 0, a mid-stream bucket switch such
        as a qa injection) pays a first use: the kernels' build, K1's and
        K5's host plans and their copies to the card, the tensor-map caches,
        the decode scratch, cuBLAS handles and the caching allocator's
        blocks. Runs, on dummy inputs at cached == 0 (what it writes into
        the arena is invisible and the first chunk overwrites it):

          * the eviction gather (identity over the arena),
          * per `grids` entry the vision encode: uint8 frames through
            `upload_frames` (`vision="frames"`), host f32 patches
            (`"patches"`), or both,
          * one chunk step per (prefill bucket x max_new x vision variant):
            a variant per grid's video-token count, plus a text-only one
            when `include_no_vision` (or when no grid is given).

        Buckets larger than the arena are skipped (the capacity guard
        refuses them). Consumes no state of the engine's sampling
        generator. Returns the number of chunk-step variants run; raises if
        any fails. Call it before streaming starts."""
        if vision not in ("none", "frames", "patches", "both"):
            raise ValueError(f"vision must be none/frames/patches/both, got {vision!r}")
        st = self.stream
        C = st.kv_capacity
        dev = self.device
        self.k_arena, self.v_arena, self.ids_arena = compact_arena(
            self.k_arena, self.v_arena, self.ids_arena, torch.arange(C, device=dev)
        )
        vcfg = self.cfg.vision
        grids = tuple(tuple(int(x) for x in g) for g in grids)
        for g in grids:
            if vision in ("frames", "both"):
                frames = np.zeros((g[0] * vcfg.temporal_patch_size, g[1] * vcfg.patch_size,
                                   g[2] * vcfg.patch_size, 3), np.uint8)
                vlm.encode_video_frames(self.cfg, self.model, self.upload_frames(frames), g,
                                        dtype=self.dtype)
            if vision in ("patches", "both"):
                patch_dim = vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size**2
                px = np.zeros((int(np.prod(g)), patch_dim), np.float32)  # as callers pass them
                vlm.encode_video(self.cfg, self.model,
                                 torch.from_numpy(px).to(dev, self.dtype), [g])
        if st.pos_mode == "shrink":
            desc, _, _, _ = self.table.position_descriptors(
                spatial_merge_size=vcfg.spatial_merge_size,
                tokens_per_second=vcfg.tokens_per_second,
                extra_text=1,
            )
            slot_pos = {k: torch.from_numpy(v).to(dev) for k, v in desc.items()}
        else:
            slot_pos = torch.from_numpy(self._pos_host.copy()).to(dev)
        vis_variants: List[Optional[int]] = [
            int(np.prod(g)) // vcfg.spatial_merge_unit for g in grids]
        if include_no_vision or not grids:
            vis_variants.append(None)
        D = self.cfg.text.hidden_size
        # a generator of its own: the engine's stream draws nothing here
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        n_run = 0
        for t_pad in buckets or st.prefill_buckets:
            if t_pad > C:
                continue
            tokens = torch.from_numpy(np.full(t_pad, self.cfg.tokens.pad, np.int64)).to(dev)
            for max_new in max_new_list or (st.max_tokens_per_chunk,):
                statics = self._statics(t_pad, max_new, eos_threshold)
                for n_vis in vis_variants:
                    ve = None if n_vis is None else torch.zeros(n_vis, D, dtype=self.dtype,
                                                                device=dev)
                    vs = None if n_vis is None else np.arange(n_vis, dtype=np.int64)
                    chunk_step(statics, self.model, self.k_arena, self.v_arena, slot_pos,
                               tokens, ve, vs, self.ids_arena, 0, 0, self.cfg.tokens.im_end,
                               max_new, gen)
                    n_run += 1
        self._sync()
        return n_run

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """The live stream's whole state (the arena's valid prefix, table,
        accounting, positions, generator state) as host numpy; see
        streaming/snapshot.py. Continuing after `restore` gives exactly the
        tokens of never having stopped."""
        from .snapshot import snapshot_arena, snapshot_host

        if self.k_arena is None:
            raise ValueError("this engine owns no arena (a multi-stream lane): use "
                             "MultiStreamEngine.snapshot_lane")
        snap = snapshot_host(self)
        snapshot_arena(snap, self.k_arena, self.v_arena, self.ids_arena)
        return snap

    def restore(self, snap: Dict[str, Any]) -> None:
        """Adopt a snapshot (from `snapshot()`, `snapshot.load_snapshot`, or
        the JAX package's) in place of this engine's stream. The configs must
        agree on kv_quant and pos_mode; kv_capacity may differ as long as it
        holds `cached` slots; the geometry must be the model's. The
        pre-rotated K copy is rebuilt from the raw arena at the next chunk,
        and the decode scratch stays as the constructor sized it."""
        from .snapshot import restore_arena, restore_host

        if self.k_arena is None:
            raise ValueError("this engine owns no arena (a multi-stream lane): use "
                             "MultiStreamEngine.restore_lane")
        restore_host(self, snap)
        restore_arena(self.k_arena, self.v_arena, self.ids_arena, snap)

    def _statics(self, t_pad: int, max_new: int, eos_threshold=None) -> ChunkStatics:
        st = self.stream
        return ChunkStatics(
            cfg=self.cfg,
            t_pad=t_pad,
            max_new=max_new,
            temperature=self.sampling.temperature,
            repetition_penalty=self.sampling.repetition_penalty,
            do_sample=self.sampling.do_sample,
            eos_threshold=eos_threshold,
            use_descriptors=(st.pos_mode == "shrink"),
            prerotate=st.effective_prerotate,
            rot_quant=st.rot_quant,
        )

    # -------------------------------------------------------------- chunks
    def process_chunk(self, *args, **kwargs) -> Tuple[np.ndarray, int]:
        """Dispatch one chunk and block for its result."""
        return self.finish_chunk(self.process_chunk_async(*args, **kwargs))

    def process_chunk_async(
        self,
        chunk_segs: List[Seg],  # segments to append for this chunk (incl. asst_open)
        pixel_patches: Optional[np.ndarray] = None,
        grid_thw: Optional[Tuple[int, int, int]] = None,
        *,
        frames_u8=None,  # [T, H, W, 3] uint8: host numpy or an upload_frames tensor
        vis_embeds: Optional[torch.Tensor] = None,  # precomputed [N_vis, D]
        max_new: Optional[int] = None,
        recompute: bool = False,  # drop the cache: the whole table re-prefills
        eos_id: Optional[int] = None,  # stop token (default <|im_end|>)
        eos_threshold: Optional[Tuple[int, float, float]] = None,  # ChunkStatics
        timer=None,  # utils.profiling.SectionTimer: PKV/INPUT/GEN sections
    ) -> ChunkHandle:
        """Evict, ingest one chunk, launch generation of up to max_new
        tokens. Returns a ChunkHandle for finish_chunk. With `recompute`,
        `vis_embeds` must hold the embeddings of every video the table
        keeps, in table order."""
        assert self._inflight is None, (
            "previous chunk not finished: call finish_chunk(handle) before the "
            "next process_chunk_async"
        )
        prep = self._prepare_chunk(
            chunk_segs, pixel_patches=pixel_patches, grid_thw=grid_thw, frames_u8=frames_u8,
            vis_embeds=vis_embeds, max_new=max_new, recompute=recompute, eos_id=eos_id,
            timer=timer,
        )
        gen, n_gen = chunk_step(
            self._statics(prep["t_pad"], prep["max_new"], eos_threshold), self.model,
            self.k_arena, self.v_arena, prep["slot_pos"],
            prep["tokens"], prep["vis_embeds"], prep["vis_slots"], self.ids_arena,
            self.cached, prep["n_real"], prep["eos"], prep["max_new"], self.generator,
        )
        self._inflight = ChunkHandle(
            gen=gen,
            n_gen=n_gen,
            n_real=prep["n_real"],
            next_p=prep["next_p"] if self.stream.pos_mode == "append" else 0.0,
            eos=prep["eos"],
            gen_cm=prep["gen_cm"],
        )
        return self._inflight

    def _prepare_chunk(
        self,
        chunk_segs: List[Seg],
        *,
        pixel_patches=None,
        grid_thw=None,
        frames_u8=None,
        vis_embeds=None,
        max_new: Optional[int] = None,
        recompute: bool = False,
        eos_id: Optional[int] = None,
        timer=None,
        extra_slots: int = 0,  # decode-delta rows beyond max_new (spec decode: k_pad)
        evict: bool = True,  # False: the caller already ran evict_plan and the gather
        device_arrays: bool = True,  # False: tokens and positions stay host numpy (a
        # multi-stream round stacks B preps and uploads them once)
    ) -> Dict[str, Any]:
        """Host-side chunk preparation: eviction, table append, token
        assembly, positions, vision encode, capacity guard. The 'GEN' timer
        section is left OPEN for finish_chunk to close. vis_slots are host
        ints either way."""

        def sec(name, sync=None):
            return timer.section(name, sync=sync) if timer else contextlib.nullcontext()

        with sec("PKV", sync=self._sync if timer else None):
            if evict:
                self.evict()
            if recompute:
                self.mark_all_uncached()
        input_cm = sec("INPUT")
        input_cm.__enter__()

        max_new = max_new or self.stream.max_tokens_per_chunk
        st = self.stream
        tkn = self.cfg.tokens
        dev = self.device

        # re-forward any uncached tail tokens along with the chunk
        tail_ids = (
            self.table.token_ids()[self.cached :] if self.uncached_tail else np.zeros(0, np.int32)
        )
        new_ids = (
            np.concatenate([s.ids for s in chunk_segs if len(s)]).astype(np.int32)
            if chunk_segs
            else np.zeros(0, np.int32)
        )
        chunk_ids = np.concatenate([tail_ids, new_ids]).astype(np.int32)
        n_real = int(chunk_ids.shape[0])
        t_pad = _bucket(n_real, st.prefill_buckets)

        C = st.kv_capacity
        total = self.cached + n_real
        n_delta = max_new + extra_slots
        # chunk_step writes t_pad rows at `cached` (the padded prefill block)
        # and n_delta rows at cached + n_real (the decode delta); both high-
        # water marks must fit. Checked before the table append so a caller
        # that catches the ValueError keeps a consistent engine.
        high_water = max(self.cached + t_pad, total + n_delta)
        if high_water > C:
            raise ValueError(
                f"KV arena capacity exceeded: need {high_water} slots "
                f"(cached={self.cached}, chunk={n_real} padded to bucket {t_pad}, "
                f"max_new={max_new}) but kv_capacity={C}. Fix: raise "
                f"StreamConfig.kv_capacity to >= {high_water} (round up to a multiple "
                f"of 512), or lower window_size/text_round/text_sink/"
                f"text_sliding_window so fewer tokens survive eviction, or add a "
                f"smaller prefill bucket."
            )
        for s in chunk_segs:
            self.table.append(s)
        self.uncached_tail = 0
        assert total == self.table.total_len()

        if st.pos_mode == "shrink":
            # contiguous re-index over the surviving table, rebuilt on the
            # device from the descriptor table
            desc, _, tot_full, next_p = self.table.position_descriptors(
                spatial_merge_size=self.cfg.vision.spatial_merge_size,
                tokens_per_second=self.cfg.vision.tokens_per_second,
                extra_text=n_delta,
            )
            assert tot_full == total + n_delta
            slot_pos = {k: torch.from_numpy(v).to(dev) for k, v in desc.items()} \
                if device_arrays else desc
        else:  # append: chunk tokens extend from last_cache_position + 1
            psegs = []
            if len(tail_ids):
                psegs.append(PosSegment("text", int(len(tail_ids))))
            for s in chunk_segs:
                if s.kind == "vision" and not st.all_text:
                    psegs.append(
                        PosSegment(
                            "video", len(s), grid_thw=s.grid_thw,
                            second_per_grid_t=s.second_per_grid_t,
                        )
                    )
                elif len(s):
                    psegs.append(PosSegment("text", len(s)))
            cpos = (
                mrope_positions_from_segments(
                    psegs,
                    spatial_merge_size=self.cfg.vision.spatial_merge_size,
                    tokens_per_second=self.cfg.vision.tokens_per_second,
                )
                + self._next_pos
            )
            self._pos_host[:, self.cached : total] = cpos
            next_p = float(cpos.max()) + 1.0 if n_real else self._next_pos
            self._pos_host[:, total : total + n_delta] = np.broadcast_to(
                np.arange(n_delta, dtype=np.float32) + next_p, (3, n_delta)
            )
            slot_pos = (torch.from_numpy(self._pos_host.copy()).to(dev) if device_arrays
                        else self._pos_host.copy())

        tokens = np.full(t_pad, tkn.pad, np.int64)
        tokens[:n_real] = chunk_ids
        input_cm.__exit__(None, None, None)

        # vision encode + the chunk step are the GEN section
        gen_cm = sec("GEN")
        gen_cm.__enter__()
        vis_slots = None
        if vis_embeds is None and frames_u8 is not None:
            vis_embeds = vlm.encode_video_frames(self.cfg, self.model, frames_u8, grid_thw,
                                                 dtype=self.dtype)
        elif vis_embeds is None and pixel_patches is not None:
            vis_embeds = vlm.encode_video(
                self.cfg, self.model,
                torch.from_numpy(np.asarray(pixel_patches)).to(dev, self.dtype),
                [tuple(int(x) for x in grid_thw)],
            )
        if vis_embeds is not None:
            # slots from SEGMENT provenance, not id matching: a sampled token
            # equal to video_pad in the re-prefilled tail claims no embed row
            # (recompute mode: cached == 0, every surviving video re-embeds)
            (slots,) = np.nonzero(self.table.vision_mask()[self.cached :])
            vis_slots = slots.astype(np.int64)

        return {
            "tokens": torch.from_numpy(tokens).to(dev) if device_arrays else tokens,
            "slot_pos": slot_pos,
            "n_real": n_real,
            "t_pad": t_pad,
            "max_new": max_new,
            "vis_embeds": vis_embeds,
            "vis_slots": vis_slots,
            "eos": tkn.im_end if eos_id is None else eos_id,
            "next_p": next_p,
            "gen_cm": gen_cm,
        }

    def process_chunk_spec(
        self,
        chunk_segs: List[Seg],
        pixel_patches: Optional[np.ndarray] = None,
        grid_thw: Optional[Tuple[int, int, int]] = None,
        *,
        frames_u8=None,
        vis_embeds: Optional[torch.Tensor] = None,
        max_new: Optional[int] = None,
        eos_id: Optional[int] = None,
        eos_threshold: Optional[Tuple[int, float, float]] = None,
        draft_fn: Optional[Callable] = None,
        k_draft: int = 7,
        timer=None,
    ) -> Tuple[np.ndarray, int]:
        """Speculative-decoding chunk (streaming/specdecode.py): the
        equivalent of process_chunk + finish_chunk, greedy emitting the
        autoregressive stream's tokens and sampling the same distribution.
        `draft_fn(context_ids, k) -> proposals` is the draft (NGramDraft,
        FixedDraft, ...); with no proposals each round emits one token.
        Each round is one verify forward of k_draft + 1 tokens (K2-verify
        over the pre-rotated float arena) and one host sync. Returns
        (generated ids including the final eos, count); the rounds taken
        are in `_spec_rounds`. Raises ValueError for a raw arena
        (prerotate_arena=False) and for rot_quant="int8"."""
        from .specdecode import SpecStatics, spec_commit_step, spec_prefill_step, spec_verify_step

        assert self._inflight is None
        st = self.stream
        if not st.effective_prerotate:
            raise ValueError("spec decode reads the pre-rotated arena; prerotate_arena=False is "
                             "not supported. Fix: leave StreamConfig.prerotate_arena on.")
        if st.rot_quant != "none":
            raise ValueError(
                "spec decode reads a float rotated K copy; rot_quant='int8' is not supported "
                "(its verify would need a dense rotated copy that the memory budget does not "
                "count). Fix: set StreamConfig.rot_quant='none', or serve without spec_decode.")
        k_pad = int(k_draft) + 1
        max_new = max_new or st.max_tokens_per_chunk
        n_delta = max_new + k_pad
        t = self.cfg.text
        G = t.num_attention_heads // t.num_key_value_heads
        if self.device.type == "cuda" and k_pad > 1:
            from ..ops._kernels import lib

            so = lib()
            if k_pad > so.verify_max_queries or n_delta + k_pad > so.verify_max_small_rows:
                raise ValueError(
                    f"spec decode: k_draft + 1 = {k_pad} (at most {so.verify_max_queries}) and "
                    f"max_new + 2 (k_draft + 1) = {n_delta + k_pad} (at most "
                    f"{so.verify_max_small_rows}) must fit the verify kernel. Fix: lower k_draft "
                    f"or max_tokens_per_chunk.")
        # before the first round: the verify's partials take k_pad heads' rows
        reserve_decode_scratch(self.device, 1, t.num_key_value_heads, st.kv_capacity, G,
                               t.head_dim, verify_queries=k_pad)
        prep = self._prepare_chunk(
            chunk_segs, pixel_patches=pixel_patches, grid_thw=grid_thw, frames_u8=frames_u8,
            vis_embeds=vis_embeds, max_new=max_new, eos_id=eos_id, timer=timer,
            extra_slots=k_pad,
        )
        statics = SpecStatics(
            cfg=self.cfg, t_pad=prep["t_pad"], k_pad=k_pad, n_delta=n_delta,
            temperature=self.sampling.temperature,
            repetition_penalty=self.sampling.repetition_penalty,
            do_sample=self.sampling.do_sample, max_new=max_new, eos_threshold=eos_threshold,
            use_descriptors=(st.pos_mode == "shrink"),
        )
        decode_base = self.cached + prep["n_real"]
        eos = prep["eos"]
        k_rot, pending, presence, delta_pos = spec_prefill_step(
            statics, self.model, self.k_arena, self.v_arena, prep["slot_pos"], prep["tokens"],
            prep["vis_embeds"], prep["vis_slots"], self.ids_arena, self.cached, prep["n_real"],
            self.generator,
        )
        # the deltas stay in the compute dtype; the commit quantizes them
        # per slot into an int8 arena
        dk = torch.zeros(t.num_hidden_layers, n_delta, t.num_key_value_heads, t.head_dim,
                         dtype=k_rot.dtype, device=self.device)
        dkr, dv = torch.zeros_like(dk), torch.zeros_like(dk)

        emitted_all: List[int] = [int(pending)]
        record = self.spec_gaps is not None
        if record:
            self.spec_gaps = [(float("nan"), float("nan"))]
        ctx_ids = self.table.token_ids()
        n_delta_cur = 0
        done = False
        rounds = 0
        while not done and len(emitted_all) < max_new:
            full_ctx = np.concatenate([ctx_ids, np.asarray(emitted_all, np.int32)])
            proposals = (np.asarray(draft_fn(full_ctx, k_draft), np.int64)
                         if draft_fn is not None else np.zeros(0, np.int64))
            inputs = np.zeros(k_pad, np.int64)
            n_prop = min(len(proposals), k_pad - 1)
            inputs[0] = emitted_all[-1]
            inputs[1 : 1 + n_prop] = proposals[:n_prop]
            gaps = [] if record else None
            out = spec_verify_step(
                statics, self.model, k_rot, self.v_arena, dk, dkr, dv, presence,
                torch.from_numpy(inputs).to(self.device), n_prop, n_delta_cur, decode_base,
                len(emitted_all), delta_pos, eos, self.generator, gaps,
            ).cpu().numpy()  # the round's one sync: ids, n_emit, n_keep, done
            n_emit, n_keep, done = int(out[k_pad]), int(out[k_pad + 1]), bool(out[k_pad + 2])
            if record:
                self.spec_gaps.extend(map(tuple, torch.stack(gaps)[:n_emit].tolist()))
            emitted_all.extend(int(x) for x in out[:n_emit])
            n_delta_cur += n_keep
            rounds += 1

        # merge the delta and the ids into the arena (rows past n_delta_cur
        # are invisible: only the valid prefix is committed below)
        pad_emit = np.zeros(n_delta, np.int64)
        pad_emit[: min(len(emitted_all), n_delta)] = emitted_all[:n_delta]
        spec_commit_step(self.k_arena, self.v_arena, self.ids_arena, dk, dv,
                         torch.from_numpy(pad_emit).to(self.device), decode_base)
        if prep["gen_cm"] is not None:
            self._sync()
            prep["gen_cm"].__exit__(None, None, None)

        # as finish_chunk: the FINAL sampled token is never committed (its
        # K/V re-prefills with the next chunk), so spec matches the AR path
        n_commit = min(n_delta_cur, max(len(emitted_all) - 1, 0))
        self.cached += prep["n_real"] + n_commit
        if st.pos_mode == "append":
            self._next_pos = prep["next_p"] + len(emitted_all)
        gen_real = np.asarray(emitted_all, np.int32)
        self.uncached_tail = len(emitted_all) - n_commit
        assert self.uncached_tail in (0, 1, 2), self.uncached_tail
        if len(gen_real) == 0 or gen_real[-1] != eos:
            gen_real = np.concatenate([gen_real, [eos]]).astype(np.int32)
            self.uncached_tail += 1
        self.chunk_index += 1
        self._spec_rounds = rounds  # observability: verify forwards this chunk
        self._spec_prefill_len = prep["n_real"]
        return gen_real, len(gen_real)

    def finish_chunk(self, handle: ChunkHandle) -> Tuple[np.ndarray, int]:
        """Materialise an in-flight chunk's generation and commit host-side
        accounting. Returns (generated ids INCLUDING the final eos, count)."""
        assert handle is self._inflight, "finish_chunk out of order"
        self._inflight = None
        gen = handle.gen.cpu().numpy().astype(np.int32)  # fences the chunk step
        n_gen = int(handle.n_gen)
        if handle.gen_cm is not None:
            handle.gen_cm.__exit__(None, None, None)
        # the FINAL sampled token of a chunk is never forwarded during that
        # chunk: it re-prefills with the next chunk under the post-eviction
        # context, so its in-loop KV is left un-committed
        n_commit = max(n_gen - 1, 0)
        self.cached += handle.n_real + n_commit
        if self.stream.pos_mode == "append":
            self._next_pos = handle.next_p + n_gen
        gen_real = gen[:n_gen]
        eos = handle.eos
        self.uncached_tail = n_gen - n_commit
        # force-close like the reference; the forced token has no KV yet
        if n_gen == 0 or gen_real[-1] != eos:
            gen_real = np.concatenate([gen_real, [eos]]).astype(np.int32)
            self.uncached_tail += 1
        self.chunk_index += 1
        return gen_real, len(gen_real)

    def finish_idle(self, handle: ChunkHandle) -> None:
        """Account an idle lane's round (multi-stream dynamic lanes): the
        batched step still ran the lane, re-forwarding any uncached tail
        (now cached) and free-running decode tokens whose output is
        discarded (their KV sits past `cached`, invisible, overwritten by
        the next real chunk). Nothing joins the table, so cached +
        uncached_tail == table length holds; chunk_index does not advance."""
        assert handle is self._inflight, "finish_idle out of order"
        self._inflight = None
        self.cached += handle.n_real
        if self.stream.pos_mode == "append":
            self._next_pos = handle.next_p

    def rollback_generation(self, n_emitted: int) -> None:
        """Drop the KV of the tokens generated this chunk (ground-truth
        teacher forcing); slots are un-counted and later overwritten."""
        written = n_emitted - self.uncached_tail
        assert written >= 0
        self.cached -= written
        self.uncached_tail = 0

    def append_uncached(self, ids: np.ndarray) -> None:
        """Declare `ids` as table-resident but not yet forwarded."""
        self.uncached_tail += len(ids)

    def commit_assistant(self, gen_real: np.ndarray, end_bias: int, rnd: int) -> None:
        """Record the generated assistant turn in the segment table, split
        into body / tail at `end_bias` tokens."""
        gen_real = np.asarray(gen_real, np.int32)
        cut = max(len(gen_real) - end_bias, 0)
        self.table.append(Seg(ASST_BODY, gen_real[:cut], round=rnd))
        self.table.append(Seg(ASST_TAIL, gen_real[cut:], round=rnd))
