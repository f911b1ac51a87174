"""Streaming engine: chunk prefill + decode over the KV arena, in PyTorch.

Port of streaming_vlm_tpu/streaming/engine.py for one stream with the
pre-rotated arena (`StreamConfig.effective_prerotate`) and a float arena
(`kv_quant="none"`, `rot_quant="none"`). One `chunk_step` per chunk does
what the JAX package's jitted step does, as eager launches:

  rotate the arena K once for the chunk's positions -> embed + vision-embed
  scatter -> chunk prefill (kernel K1) -> a `max_new`-step decode loop
  (kernel K2, repetition-penalty sampling) -> merge the new K/V.

The arenas are updated IN PLACE (the JAX package donates them instead);
eviction gathers into fresh tensors with index_select, never in place. The
decode loop always runs `max_new` steps and keeps every token on the device
(tokens after `done` are eos, n_gen = sum(~was_done)), so a chunk needs one
host sync, in `finish_chunk`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from streaming_vlm_tpu.utils.buckets import bucket_for

from ..config import ModelConfig, SamplingConfig, StreamConfig
from ..models.qwen25_vl import language, model as vlm
from ..models.qwen25_vl.rope import (
    PosSegment,
    apply_rope,
    mrope_cos_sin,
    mrope_positions_from_segments,
)
from ..ops.sampling import sample_token
from .segments import ASST_BODY, ASST_TAIL, Seg, SegmentTable

# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------


def positions_from_descriptors(desc: Dict[str, torch.Tensor], capacity: int) -> torch.Tensor:
    """Rebuild the [3, C] mRoPE position tensor on the device from the
    segment descriptor table (SegmentTable.position_descriptors). Slots
    past the last real segment get garbage positions but are invisible."""
    starts = desc["starts"].long()
    slot = torch.arange(capacity, dtype=torch.long, device=starts.device)
    sid = (torch.searchsorted(starts, slot, right=True) - 1).clamp_min(0)
    off = slot - starts[sid]
    gh = desc["ghs"].long()[sid]
    gw = desc["gws"].long()[sid]
    is_vid = desc["kinds"][sid] == 1
    offf = off.float()
    t = torch.where(is_vid, torch.div(off, gh * gw, rounding_mode="floor").float() * desc["tsteps"][sid], offf)
    h = torch.where(is_vid, (torch.div(off, gw, rounding_mode="floor") % gh).float(), offf)
    w = torch.where(is_vid, (off % gw).float(), offf)
    return desc["bases"][sid][None, :] + torch.stack([t, h, w])


def compact_arena(k_arena, v_arena, ids_arena, src_idx: torch.Tensor):
    """new[:, i] = old[:, src_idx[i]], gathered into fresh tensors."""
    return (
        k_arena.index_select(1, src_idx),
        v_arena.index_select(1, src_idx),
        ids_arena.index_select(0, src_idx),
    )


def _merge_block(arena: torch.Tensor, block: torch.Tensor, at: int) -> None:
    """Write a [L, T, Hkv, hd] block into arena slots [at, at + T), in place."""
    T = block.shape[1]
    if not (0 <= at and at + T <= arena.shape[1]):
        raise ValueError(f"block [{at}, {at + T}) outside the arena's {arena.shape[1]} slots")
    arena[:, at : at + T] = block.to(arena.dtype)


@dataclasses.dataclass
class ChunkHandle:
    """In-flight chunk: device results + the host state finish_chunk needs."""

    gen: torch.Tensor  # [max_new] int64 on the device
    n_gen: torch.Tensor  # 0-d int64 on the device
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
    # positions arrive as a descriptor table (shrink mode) instead of [3, C]
    use_descriptors: bool = False


@torch.no_grad()
def chunk_step(
    statics: ChunkStatics,
    model: vlm.Qwen25VL,
    k_arena: torch.Tensor,  # [L, C, Hkv, hd], updated in place
    v_arena: torch.Tensor,
    slot_positions,  # [3, C] f32, or the descriptor dict of device tensors
    tokens: torch.Tensor,  # [t_pad] int64 (padded)
    vis_embeds: Optional[torch.Tensor],  # [N_vis, D] or None
    vis_slots: Optional[torch.Tensor],  # [N_vis] int64 rows within the chunk
    ids_arena: torch.Tensor,  # [C] int64, updated in place
    insert_at: int,  # first arena slot of the chunk's tokens
    n_real: int,  # real (unpadded) chunk length
    eos_id: int,
    n_max: int,  # decode budget <= statics.max_new
    generator: Optional[torch.Generator],
):
    """Returns (gen [max_new] int64, n_gen 0-d int64), both on the device."""
    cfg = statics.cfg
    tcfg = cfg.text
    lm = model.text
    C = k_arena.shape[1]
    dev = k_arena.device
    if statics.use_descriptors:
        slot_positions = positions_from_descriptors(slot_positions, C)

    # rotate the whole arena K once for this chunk's (fixed) positions: the
    # prefill and every decode step read the rotated copy; the raw arena is
    # what persists across chunks
    a_cos, a_sin = mrope_cos_sin(slot_positions, lm.inv_freq(dev), tcfg.mrope_section)
    k_rot = apply_rope(k_arena, a_cos[:, None, :], a_sin[:, None, :])

    # chunk token ids, then the repetition-penalty presence mask (slot V
    # takes the dropped ids of invisible slots)
    V = tcfg.vocab_size
    ids_arena[insert_at : insert_at + statics.t_pad] = tokens
    valid = torch.arange(C, device=dev) < insert_at + n_real
    presence = torch.zeros(V + 1, dtype=torch.bool, device=dev)
    presence[torch.where(valid, ids_arena, V)] = True
    presence = presence[:V]

    embeds = language.embed_tokens(tcfg, lm, tokens)
    if vis_embeds is not None:
        embeds = vlm.merge_vision_embeds(embeds, vis_embeds, vis_slots)

    q_pos = slot_positions[:, insert_at : insert_at + statics.t_pad]
    hidden, (k_block, k_block_rot, v_block) = language.language_forward_streaming(
        tcfg, lm, embeds, q_pos, arena=(k_rot, v_arena), arena_rotated=True,
        visible_len=insert_at,
    )
    _merge_block(k_arena, k_block, insert_at)
    _merge_block(k_rot, k_block_rot, insert_at)
    _merge_block(v_arena, v_block, insert_at)
    logits = language.lm_logits(tcfg, lm, hidden[n_real - 1 : n_real])[0]

    decode_base = insert_at + n_real
    max_new = statics.max_new
    delta_pos = slot_positions[:, decode_base : decode_base + max_new]
    L, Hkv, hd = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim
    dk = torch.zeros(L, max_new, Hkv, hd, dtype=k_arena.dtype, device=dev)
    dkr = torch.zeros_like(dk)
    dv = torch.zeros_like(dk)
    gen = torch.empty(max_new, dtype=torch.long, device=dev)
    was_done = torch.empty(max_new, dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eos = torch.full((), eos_id, dtype=torch.long, device=dev)
    for step in range(max_new):
        tok = sample_token(
            generator, logits, presence,
            temperature=statics.temperature,
            repetition_penalty=statics.repetition_penalty,
            do_sample=statics.do_sample,
        )
        tok = torch.where(done, eos, tok)
        presence.index_fill_(0, tok.view(1), True)
        gen[step] = tok
        was_done[step] = done
        # a lane is done at its own budget exactly like a natural eos
        done = done | (tok == eos) | (step + 1 >= n_max)

        emb = language.embed_tokens(tcfg, lm, tok.view(1))
        hidden, (k1, k1_rot, v1) = language.language_forward_streaming(
            tcfg, lm, emb, delta_pos[:, step : step + 1],
            arena=(k_rot, v_arena), arena_rotated=True, visible_len=decode_base,
            extra=(dkr, dv), extra_visible=step,
        )
        dk[:, step] = k1[:, 0]
        dkr[:, step] = k1_rot[:, 0]
        dv[:, step] = v1[:, 0]
        logits = language.lm_logits(tcfg, lm, hidden)[0]

    _merge_block(k_arena, dk, decode_base)
    _merge_block(v_arena, dv, decode_base)
    ids_arena[decode_base : decode_base + max_new] = gen
    return gen, (~was_done).sum()


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
    ):
        if not stream.effective_prerotate or stream.kv_quant != "none" or stream.rot_quant != "none":
            raise NotImplementedError(
                "the port runs the pre-rotated float arena only: prerotate_arena "
                "must not be False, kv_quant and rot_quant must be 'none'"
            )
        self.cfg = cfg
        self.model = model
        self.stream = stream
        self.sampling = sampling
        self.dtype = dtype
        self.device = model.text.embed.weight.device
        self.table = SegmentTable(all_text=stream.all_text)
        C = stream.kv_capacity
        self._check_memory_budget()
        self.k_arena, self.v_arena = language.init_kv_arena(cfg.text, C, dtype, self.device)
        self.ids_arena = torch.zeros(C, dtype=torch.long, device=self.device)
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

    # -------------------------------------------------------------- plumbing
    def _check_memory_budget(self) -> None:
        """Fail BEFORE allocating if the K/V arenas and the per-chunk
        rotated K copy do not fit the card's free memory (10% headroom for
        prefill/decode transients). No check on the CPU."""
        if self.device.type != "cuda":
            return
        t = self.cfg.text
        C = self.stream.kv_capacity
        item = torch.empty((), dtype=self.dtype).element_size()
        per_copy = t.num_hidden_layers * C * t.num_key_value_heads * t.head_dim * item
        need = int(3 * per_copy * 1.1)  # K, V, rotated K
        free, _ = torch.cuda.mem_get_info(self.device)
        if need > free:
            gb = 2**30
            max_c = int(free / 1.1 / (3 * per_copy / C) // 512 * 512)
            raise ValueError(
                f"device memory exceeded before streaming: KV arena + rotated copy "
                f"{need / gb:.2f} GiB > free {free / gb:.2f} GiB. Fix: lower "
                f"kv_capacity to <= {max_c}, or shorten the window so fewer tokens "
                f"survive eviction."
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
        vis_embeds: Optional[torch.Tensor] = None,  # precomputed [N_vis, D]
        max_new: Optional[int] = None,
        eos_id: Optional[int] = None,  # stop token (default <|im_end|>)
        timer=None,  # utils.profiling.SectionTimer: PKV/INPUT/GEN sections
    ) -> ChunkHandle:
        """Evict, ingest one chunk, launch generation of up to max_new
        tokens. Returns a ChunkHandle for finish_chunk."""
        assert self._inflight is None, (
            "previous chunk not finished: call finish_chunk(handle) before the "
            "next process_chunk_async"
        )
        prep = self._prepare_chunk(
            chunk_segs, pixel_patches=pixel_patches, grid_thw=grid_thw,
            vis_embeds=vis_embeds, max_new=max_new, eos_id=eos_id, timer=timer,
        )
        st = self.stream
        statics = ChunkStatics(
            cfg=self.cfg,
            t_pad=prep["t_pad"],
            max_new=prep["max_new"],
            temperature=self.sampling.temperature,
            repetition_penalty=self.sampling.repetition_penalty,
            do_sample=self.sampling.do_sample,
            use_descriptors=(st.pos_mode == "shrink"),
        )
        gen, n_gen = chunk_step(
            statics, self.model, self.k_arena, self.v_arena, prep["slot_pos"],
            prep["tokens"], prep["vis_embeds"], prep["vis_slots"], self.ids_arena,
            self.cached, prep["n_real"], prep["eos"], prep["max_new"], self.generator,
        )
        self._inflight = ChunkHandle(
            gen=gen,
            n_gen=n_gen,
            n_real=prep["n_real"],
            next_p=prep["next_p"] if st.pos_mode == "append" else 0.0,
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
        vis_embeds=None,
        max_new: Optional[int] = None,
        eos_id: Optional[int] = None,
        timer=None,
    ) -> Dict[str, Any]:
        """Host-side chunk preparation: eviction, table append, token
        assembly, positions, vision encode, capacity guard. The 'GEN' timer
        section is left OPEN for finish_chunk to close."""

        def sec(name, sync=None):
            return timer.section(name, sync=sync) if timer else contextlib.nullcontext()

        with sec("PKV", sync=self._sync if timer else None):
            self.evict()
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
        # chunk_step writes t_pad rows at `cached` (the padded prefill block)
        # and max_new rows at cached + n_real (the decode delta); both high-
        # water marks must fit. Checked before the table append so a caller
        # that catches the ValueError keeps a consistent engine.
        high_water = max(self.cached + t_pad, total + max_new)
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
                extra_text=max_new,
            )
            assert tot_full == total + max_new
            slot_pos = {k: torch.from_numpy(v).to(dev) for k, v in desc.items()}
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
            self._pos_host[:, total : total + max_new] = np.broadcast_to(
                np.arange(max_new, dtype=np.float32) + next_p, (3, max_new)
            )
            slot_pos = torch.from_numpy(self._pos_host.copy()).to(dev)

        tokens = np.full(t_pad, tkn.pad, np.int64)
        tokens[:n_real] = chunk_ids
        input_cm.__exit__(None, None, None)

        # vision encode + the chunk step are the GEN section
        gen_cm = sec("GEN")
        gen_cm.__enter__()
        vis_slots = None
        if vis_embeds is None and pixel_patches is not None:
            vis_embeds = vlm.encode_video(
                self.cfg, self.model,
                torch.from_numpy(np.asarray(pixel_patches)).to(dev, self.dtype),
                [tuple(int(x) for x in grid_thw)],
            )
        if vis_embeds is not None:
            # slots from SEGMENT provenance, not id matching: a sampled token
            # equal to video_pad in the re-prefilled tail claims no embed row
            (slots,) = np.nonzero(self.table.vision_mask()[self.cached :])
            vis_slots = torch.from_numpy(slots.astype(np.int64)).to(dev)

        return {
            "tokens": torch.from_numpy(tokens).to(dev),
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
