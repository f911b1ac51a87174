"""Multi-stream serving: B independent live streams on one card.

Port of streaming_vlm_tpu/streaming/multistream.py (without its TP/DP
mesh). One stream's decode reads every weight once
per token; B streams in lockstep rounds share each of those reads:

  1. every lane's eviction policy runs on the host (`evict_plan`), and the
     lanes' gather plans go to one `compact_arena_batched`;
  2. every lane's chunk is prepared by the single-stream engine's own
     `_prepare_chunk` (evict=False, host numpy out), padded to the round's
     common prefill bucket and stacked, then uploaded once;
  3. one `chunk_step_batched` prefills and decodes all lanes in one pass
     of the decoder stack: one product per projection over all lanes'
     rows, one lane-form kernel launch per layer for attention. Per-lane
     insert points, lengths, positions and generators keep each lane's
     results those of a solo engine.

The stacked arena is [B, L, C, Hkv, hd] (float, or QuantKV with int8 KV);
the per-lane `StreamingEngine`s (allocate_arena=False) keep only host
state. A lane with no chunk in a round passes None (idle): it still flows
through the step (its uncached tail re-forwards; its decode output is
discarded), its table and chunk clock do not advance, a vision round drops
its rows of the embeddings, and its sampling generator does not advance.
`reset_lane` hands a lane to a new client mid-flight; `snapshot_lane` /
`restore_lane` move a live stream out of or into a lane in the format of
`StreamingEngine.snapshot` (streaming/snapshot.py), other lanes untouched.

Sampling: lane b draws from its own `torch.Generator`, seeded with
`sampling.seed + b` (so lane 0 draws what a solo engine with the same
SamplingConfig draws); `reset_lane(b)` reseeds it with
`sampling.seed + b + n_streams * k` at its k-th reset unless given a seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, SamplingConfig, StreamConfig
from ..models.qwen25_vl import language, model as vlm
from ..ops.attention import reserve_decode_scratch
from .engine import (
    ChunkHandle,
    StreamingEngine,
    _bucket,
    chunk_step_batched,
    compact_arena_batched,
)


def lane_seed(seed: int, b: int, n_streams: int, resets: int = 0) -> int:
    """The seed of lane b's generator after `resets` resets of the lane."""
    return int(seed) + b + n_streams * resets


class MultiStreamEngine:
    """Owns the stacked device arena for B streams + B host-side engines."""

    def __init__(
        self,
        cfg: ModelConfig,
        model: vlm.Qwen25VL,
        stream: StreamConfig,
        sampling: SamplingConfig,
        n_streams: int,
        dtype: torch.dtype = torch.bfloat16,
    ):
        assert n_streams >= 1
        self.cfg = cfg
        self.model = model
        self.stream = stream
        self.sampling = sampling
        self.dtype = dtype
        self.n = n_streams
        self.device = model.text.embed.weight.device
        self.engines = [self._lane_engine() for _ in range(n_streams)]
        self._check_memory_budget()
        t = cfg.text
        C = stream.kv_capacity
        # int8 lanes: the arena is the marginal memory per stream, so halving
        # it raises the lane count one card holds
        self.k_arena, self.v_arena = language.init_kv_arena(
            t, C, dtype, self.device, quant=stream.kv_quant, lead_dims=(n_streams,)
        )
        self.ids_arena = torch.zeros(n_streams, C, dtype=torch.long, device=self.device)
        # the decode kernels' scratch, sized once for every round's largest call
        reserve_decode_scratch(self.device, n_streams, t.num_key_value_heads, C,
                               t.num_attention_heads // t.num_key_value_heads, t.head_dim)
        self._ident_src = np.arange(C, dtype=np.int64)
        self._resets = [0] * n_streams
        self.generators = [self._generator(lane_seed(sampling.seed, b, n_streams))
                           for b in range(n_streams)]
        self._inflight: Optional[List[ChunkHandle]] = None
        self._inflight_idle: Optional[List[bool]] = None
        self._gen_all: Optional[torch.Tensor] = None

    def _lane_engine(self) -> StreamingEngine:
        return StreamingEngine(self.cfg, self.model, self.stream, self.sampling,
                               dtype=self.dtype, allocate_arena=False)

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    # ------------------------------------------------------------------ sizing
    def _check_memory_budget(self) -> None:
        """The single-stream check scaled by B: B arenas + B rotated copies
        (int8 with rot_quant="int8", else the engine dtype) against the
        card's free memory, 10% headroom; the weights are shared and already
        resident. No check on the CPU."""
        if self.device.type != "cuda":
            return
        t = self.cfg.text
        st = self.stream
        C = st.kv_capacity
        item = torch.empty((), dtype=self.dtype).element_size()
        kv_elems = self.n * t.num_hidden_layers * C * t.num_key_value_heads * t.head_dim
        int8 = int(kv_elems * (1 + 4.0 / t.head_dim))  # data + f32 per-(slot, head) scales
        arena = 2 * (int8 if st.kv_quant == "int8" else kv_elems * item)
        if not st.effective_prerotate:
            rot = 0
        elif st.rot_quant == "int8":
            rot = int8
        else:
            rot = kv_elems * item
        need = int((arena + rot) * 1.1)
        free, _ = torch.cuda.mem_get_info(self.device)
        if need > free:
            gb = 2**30
            max_b = int(free / 1.1 / ((arena + rot) / self.n))
            raise ValueError(
                f"device memory exceeded: {self.n} stream arenas {arena / gb:.2f} GiB"
                + (f" + rotated copies {rot / gb:.2f} GiB" if rot else "")
                + f" > free {free / gb:.2f} GiB. Fix: at this kv_capacity the card fits at "
                f"most {max_b} streams (or set kv_quant='int8' to halve the arenas, "
                f"rot_quant='int8' to halve the rotated copies, lower kv_capacity, or set "
                f"prerotate_arena=False)."
            )

    # ------------------------------------------------------------------ warmup
    def prewarm(
        self,
        grids: Tuple[Tuple[int, int, int], ...] = (),
        *,
        buckets: Optional[Tuple[int, ...]] = None,
        max_new_list: Optional[Tuple[int, ...]] = None,
        include_no_vision: bool = False,
        eos_threshold: Optional[Tuple[int, float, float]] = None,
    ) -> int:
        """`StreamingEngine.prewarm` for the batched step, before round 0:
        the batched eviction gather, per grid the round's encode (B lanes'
        host f32 patches, and one lane's as `encode_round_mixed` uploads
        it), and every (bucket x max_new x vision variant) batched step on
        dummy inputs at cached == 0 for all lanes. The lanes' generators do
        not advance. Returns the number of step variants run."""
        st = self.stream
        C = st.kv_capacity
        dev = self.device
        self.k_arena, self.v_arena, self.ids_arena = compact_arena_batched(
            self.k_arena, self.v_arena, self.ids_arena,
            torch.from_numpy(np.tile(self._ident_src, (self.n, 1))).to(dev),
        )
        vcfg = self.cfg.vision
        D = self.cfg.text.hidden_size
        grids = tuple(tuple(int(x) for x in g) for g in grids)
        patch_dim = vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size**2
        vis_variants: List[Optional[int]] = []
        for g in grids:
            S = int(np.prod(g))
            self.encode_round(np.zeros((self.n, S, patch_dim), np.float32), g)
            self.encode_round_mixed([np.zeros((S, patch_dim), np.float32)] + [None] * (self.n - 1),
                                    [g] + [None] * (self.n - 1))
            vis_variants.append(S // vcfg.spatial_merge_unit)
        if include_no_vision or not grids:
            vis_variants.append(None)
        lane = self.engines[0]
        if st.pos_mode == "shrink":
            desc, _, _, _ = lane.table.position_descriptors(
                spatial_merge_size=vcfg.spatial_merge_size,
                tokens_per_second=vcfg.tokens_per_second,
                extra_text=1,
            )
            slot_pos = {k: torch.from_numpy(np.tile(v, (self.n, 1))).to(dev)
                        for k, v in desc.items()}
        else:
            slot_pos = torch.zeros(self.n, 3, C, device=dev)
        gens = [self._generator(0) for _ in range(self.n)]  # the lanes' own stay untouched
        zeros, eos = [0] * self.n, [self.cfg.tokens.im_end] * self.n
        n_run = 0
        for t_pad in buckets or st.prefill_buckets:
            if t_pad > C:
                continue
            tokens = torch.from_numpy(np.full((self.n, t_pad), self.cfg.tokens.pad,
                                              np.int64)).to(dev)
            for max_new in max_new_list or (st.max_tokens_per_chunk,):
                statics = lane._statics(t_pad, max_new, eos_threshold)
                for n_vis in vis_variants:
                    ve = None if n_vis is None else torch.zeros(self.n, n_vis, D,
                                                                dtype=self.dtype, device=dev)
                    vs = None if n_vis is None else np.tile(np.arange(n_vis), (self.n, 1))
                    chunk_step_batched(statics, self.model, self.k_arena, self.v_arena,
                                       slot_pos, tokens, ve, vs, self.ids_arena, zeros, zeros,
                                       eos, [max_new] * self.n, gens)
                    n_run += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n_run

    # ------------------------------------------------------------------ vision
    def encode_round_mixed(
        self,
        pixel_patches: Sequence[Optional[np.ndarray]],  # per lane [S_b, patch_dim]
        grids: Sequence[Optional[Tuple[int, int, int]]],
    ) -> List[Optional[torch.Tensor]]:
        """Encode a round whose lanes carry their own grids (clients at
        different resolutions): one vision-tower call per lane with video.
        Returns per-lane [n_vis_b, D] embeddings (None where the lane has no
        video) for `process_round_async(vis_embeds=<this list>)`."""
        assert len(pixel_patches) == len(grids) == self.n
        out: List[Optional[torch.Tensor]] = []
        for pat, g in zip(pixel_patches, grids):
            if pat is None:
                out.append(None)
                continue
            assert g is not None, "pixel_patches without grid_thw"
            px = torch.from_numpy(np.asarray(pat)).to(self.device, self.dtype)
            out.append(vlm.encode_video(self.cfg, self.model, px, [tuple(int(x) for x in g)]))
        return out

    def encode_round(self, pixel_patches, grid_thw) -> torch.Tensor:
        """Encode every lane's chunk at one grid: B vision-tower calls (one
        call over the concatenated lanes would mask a [B S, B S] score
        matrix to block-diagonal, B times the work) and one stack.
        pixel_patches [B, S, patch_dim]; returns [B, S // merge_unit, D]."""
        B = len(pixel_patches)
        assert B == self.n
        g = tuple(int(x) for x in grid_thw)
        pat = torch.as_tensor(pixel_patches).to(self.device, self.dtype)
        return torch.stack([vlm.encode_video(self.cfg, self.model, pat[b], [g]) for b in range(B)])

    # ------------------------------------------------------------------ round
    def evict_round(self) -> None:
        """Run every lane's eviction policy (host table edits) and apply the
        lanes' gather plans in one batched gather. Idempotent between
        commits (the policies are keyed on each lane's chunk_index, which
        only advances at commit), so a serving layer may call it before a
        round to see post-evict occupancy."""
        plans = [e.evict_plan() for e in self.engines]
        if any(p.changed for p in plans):
            src = np.tile(self._ident_src, (self.n, 1))
            for b, p in enumerate(plans):
                if p.changed:
                    src[b, : p.src.shape[0]] = p.src
            self.k_arena, self.v_arena, self.ids_arena = compact_arena_batched(
                self.k_arena, self.v_arena, self.ids_arena, torch.from_numpy(src).to(self.device)
            )

    def round_capacity_error(self, n_reals: Sequence[int], max_new: int) -> Optional[ValueError]:
        """The round's atomic capacity pre-pass, as a question: would a
        round with these per-lane real token counts (idle lanes: their
        uncached tail) and this round-max decode budget overflow any lane?
        Every lane pays the round's shared bucket and decode length, idle
        lanes too. Returns the first offending lane's error without
        changing anything, or None."""
        st = self.stream
        t_shared = max(_bucket(n, st.prefill_buckets) for n in n_reals)
        for b, e in enumerate(self.engines):
            hw = max(e.cached + t_shared, e.cached + n_reals[b] + max_new)
            if hw > st.kv_capacity:
                return ValueError(
                    f"stream {b}: round needs {hw} slots (cached={e.cached}, chunk="
                    f"{n_reals[b]} padded to the round's shared bucket {t_shared}, max_new="
                    f"{max_new}) but kv_capacity={st.kv_capacity}; raise kv_capacity or "
                    f"align stream protocols. No lane state was modified."
                )
        return None

    def process_round_async(
        self,
        chunk_segs: Sequence[Optional[List]],  # B lists of Seg; None: the lane is idle
        *,
        vis_embeds=None,  # [B, N_vis, D] (uniform round), a per-lane list of Optional
        # [n_vis_b, D] (mixed-grid round: encode_round_mixed), or None (text only)
        grid_thw=None,  # one (t, h, w) for the round, or a per-lane list
        max_new=None,  # an int for every lane, or per-lane budgets (None: the default)
        eos_id: Optional[int] = None,
        eos_threshold: Optional[Tuple[int, float, float]] = None,  # ChunkStatics
    ) -> List[ChunkHandle]:
        """Evict + ingest one chunk per lane, launch one batched step.
        Returns per-lane handles; call finish_round() for the results.

        An idle lane (None) still flows through the step (static work a
        round; its output is wasted by design) through `_prepare_chunk([])`:
        any uncached tail re-forwards and becomes cached, the decode output
        is discarded, its table, generator and chunk clock do not advance,
        and a vision round's rows for it point past the chunk (dropped).
        Lanes still run eviction, so `cached` stays at the post-evict bound
        that the capacity pre-pass certifies."""
        assert self._inflight is None, "previous round not finished"
        assert len(chunk_segs) == self.n
        st = self.stream
        # per-lane decode budgets; the round's decode length is the largest,
        # each lane stops emitting at its own
        if isinstance(max_new, (list, tuple, np.ndarray)):
            assert len(max_new) == self.n
            budgets = [int(m) if m is not None else st.max_tokens_per_chunk for m in max_new]
        else:
            budgets = [int(max_new or st.max_tokens_per_chunk)] * self.n
        assert all(m >= 1 for m in budgets), budgets
        max_new = max(budgets)
        idle = [cs is None for cs in chunk_segs]
        mixed = isinstance(vis_embeds, (list, tuple))
        if mixed:
            assert len(vis_embeds) == self.n
        per_lane_grid = grid_thw is not None and not isinstance(grid_thw[0], (int, np.integer))
        if per_lane_grid:
            assert len(grid_thw) == self.n

        # 1. eviction: host table edits, then one batched gather
        self.evict_round()

        # 1b. the atomic capacity pre-pass, before any _prepare_chunk
        # appends to a table (raising after some lanes prepped would leave
        # tables claiming tokens whose KV is never written)
        n_reals = [
            e.uncached_tail + (0 if idle[b] else sum(len(s.ids) for s in chunk_segs[b]))
            for b, e in enumerate(self.engines)
        ]
        err = self.round_capacity_error(n_reals, max_new)
        if err is not None:
            raise err

        # 2. per-lane host prep by the single-stream code; idle lanes prep
        # an empty chunk (tail re-forward only). Host numpy out: the round
        # stacks and uploads once.
        preps = [
            e._prepare_chunk(
                [] if idle[b] else list(chunk_segs[b]),
                # the whole structure, never vis_embeds[b]: _prepare_chunk
                # only checks not-None (its vis_slots come from the lane's
                # own chunk)
                vis_embeds=None if vis_embeds is None or idle[b] else vis_embeds,
                grid_thw=None if idle[b] else (grid_thw[b] if per_lane_grid else grid_thw),
                max_new=max_new,
                eos_id=eos_id,
                evict=False,
                device_arrays=False,
            )
            for b, e in enumerate(self.engines)
        ]

        # the common bucket: every lane pads to the round's largest
        t_pad = max(p["t_pad"] for p in preps)
        tokens = np.full((self.n, t_pad), self.cfg.tokens.pad, np.int64)
        for b, p in enumerate(preps):
            tokens[b, : p["tokens"].shape[0]] = p["tokens"]
            hw = max(self.engines[b].cached + t_pad, p_high_water(self, b, p, max_new))
            if hw > st.kv_capacity:
                raise ValueError(
                    f"stream {b}: shared bucket {t_pad} overflows kv_capacity "
                    f"{st.kv_capacity} at cached={self.engines[b].cached}; raise kv_capacity "
                    f"or align stream protocols"
                )

        # positions: the lanes' descriptor tables (shrink) stacked with
        # fills past their segments, or the [3, C] arrays (append)
        dev = self.device
        if st.pos_mode == "shrink":
            max_segs = max(p["slot_pos"]["starts"].shape[0] for p in preps)
            fill = {"starts": 2**30, "ghs": 1, "gws": 1, "tsteps": 1.0}
            slot_pos = {}
            for k, first in preps[0]["slot_pos"].items():
                stacked = np.full((self.n, max_segs), fill.get(k, 0), np.asarray(first).dtype)
                for b, p in enumerate(preps):
                    v = np.asarray(p["slot_pos"][k])
                    stacked[b, : v.shape[0]] = v
                slot_pos[k] = torch.from_numpy(stacked).to(dev)
        else:
            slot_pos = torch.from_numpy(np.stack([p["slot_pos"] for p in preps])).to(dev)

        vs = ve = None
        if mixed:
            # lanes carry different vision-token counts: pad every lane to
            # the round's largest; pad rows point at slot t_pad (dropped)
            counts = [0 if (e is None or idle[b]) else int(e.shape[0])
                      for b, e in enumerate(vis_embeds)]
            for b, p in enumerate(preps):
                # a lane whose chunk carries video_pad tokens with no embeds
                # would forward raw pad-token embeddings
                assert counts[b] or idle[b] or p["vis_slots"] is None or not len(p["vis_slots"]), (
                    f"lane {b}: chunk carries video_pad tokens but its vis_embeds entry is None")
            if any(counts):
                max_nv = max(counts)
                D = self.cfg.text.hidden_size
                vs = np.full((self.n, max_nv), t_pad, np.int64)
                ve = torch.zeros(self.n, max_nv, D, dtype=self.dtype, device=dev)
                for b, (p, e) in enumerate(zip(preps, vis_embeds)):
                    nb = counts[b]
                    if nb:
                        assert p["vis_slots"] is not None, (
                            f"lane {b}: vision embeds supplied but the chunk carries no "
                            f"video_pad tokens")
                        assert len(p["vis_slots"]) == nb, (
                            f"lane {b}: chunk has {len(p['vis_slots'])} video_pad tokens but "
                            f"{nb} vision embeds were supplied")
                        vs[b, :nb] = p["vis_slots"]
                        ve[b, :nb] = torch.as_tensor(e, device=dev).to(self.dtype)
        elif vis_embeds is not None:
            n_vis = int(vis_embeds.shape[1])
            # a text-only active lane preps against the stacked embeds and
            # gets an empty (not None) vis_slots: it counts as visionless
            active_nv = {len(p["vis_slots"]) for b, p in enumerate(preps)
                         if not idle[b] and p["vis_slots"] is not None and len(p["vis_slots"])}
            assert active_nv <= {n_vis}, (
                f"every lane's chunk carrying video must carry the round's video-token count "
                f"{n_vis} (got {active_nv}); mixed counts go through a per-lane embeds list")
            # idle and text-only lanes: slots past the chunk, dropped
            vs = np.full((self.n, n_vis), t_pad, np.int64)
            for b, p in enumerate(preps):
                if p["vis_slots"] is not None and len(p["vis_slots"]):
                    vs[b] = p["vis_slots"]
            ve = torch.as_tensor(vis_embeds, device=dev).to(self.dtype)

        statics = self.engines[0]._statics(t_pad, max_new, eos_threshold)
        # an idle lane's generator does not advance (its stream resumes
        # exactly where a solo engine that skipped the round would)
        gens = [None if idle[b] else g for b, g in enumerate(self.generators)]
        gen, n_gen = chunk_step_batched(
            statics, self.model, self.k_arena, self.v_arena, slot_pos,
            torch.from_numpy(tokens).to(dev), ve, vs, self.ids_arena,
            [e.cached for e in self.engines], [p["n_real"] for p in preps],
            [p["eos"] for p in preps], budgets, gens,
        )
        handles = []
        for p, e in zip(preps, self.engines):
            # gen / n_gen stay None until finish_round fills them from the
            # round's one device-to-host copy
            h = ChunkHandle(gen=None, n_gen=None, n_real=p["n_real"],
                            next_p=p["next_p"] if st.pos_mode == "append" else 0.0,
                            eos=p["eos"], gen_cm=None)
            e._inflight = h
            handles.append(h)
        self._inflight = handles
        self._inflight_idle = idle
        self._gen_all = torch.cat([gen, n_gen[:, None]], dim=1)
        return handles

    def finish_round(
        self, handles: Optional[List[ChunkHandle]] = None
    ) -> List[Optional[Tuple[np.ndarray, int]]]:
        """Materialise the round (one device-to-host copy for all lanes):
        per lane (generated ids incl. eos, count), None for idle lanes."""
        handles = handles or self._inflight
        assert handles is self._inflight
        idle = self._inflight_idle
        self._inflight = self._inflight_idle = None
        all_ = self._gen_all.cpu().numpy()  # fences the round's step
        self._gen_all = None
        out = []
        for b, (e, h) in enumerate(zip(self.engines, handles)):
            h.gen, h.n_gen = torch.from_numpy(all_[b, :-1]), int(all_[b, -1])
            if idle[b]:
                e.finish_idle(h)
                out.append(None)
            else:
                out.append(e.finish_chunk(h))
        return out

    def process_round(self, *args, **kwargs) -> List[Optional[Tuple[np.ndarray, int]]]:
        return self.finish_round(self.process_round_async(*args, **kwargs))

    def commit_assistant(self, gens: Sequence[Optional[np.ndarray]], end_bias: int,
                         rnd: int) -> None:
        """Commit each lane's generation; None entries (idle lanes) skip."""
        for e, g in zip(self.engines, gens):
            if g is not None:
                e.commit_assistant(g, end_bias, rnd)

    def reset_lane(self, b: int, seed: Optional[int] = None) -> None:
        """Hand lane b to a new client mid-flight: fresh host state (table,
        positions, accounting) and a freshly seeded generator (`seed`, or
        `lane_seed` of its next reset). The lane's stale arena content
        needs no clearing: at cached=0 nothing is visible and the first
        chunk overwrites from slot 0. Other lanes are untouched."""
        assert self._inflight is None, "reset_lane mid-round"
        self.engines[b] = self._lane_engine()
        self._resets[b] += 1
        if seed is None:
            seed = lane_seed(self.sampling.seed, b, self.n, self._resets[b])
        self.generators[b] = self._generator(seed)


    def snapshot_lane(self, b: int) -> Dict:
        """Lane b's live stream as a snapshot (streaming/snapshot.py), the
        format of StreamingEngine.snapshot, so that a lane can be written
        to disk, or restored into a solo engine or another lane. Its "rng"
        is the lane's generator (`generators[b]`), not the lane engine's
        unused one."""
        from ..ops.quant import lane
        from .snapshot import generator_state, snapshot_arena, snapshot_host

        assert self._inflight is None, "snapshot_lane mid-round"
        snap = snapshot_host(self.engines[b])
        snap["rng"] = generator_state(self.generators[b])
        snapshot_arena(snap, lane(self.k_arena, b), lane(self.v_arena, b), self.ids_arena[b])
        return snap

    def restore_lane(self, b: int, snap: Dict) -> None:
        """Adopt a snapshot into lane b (a live stream joining the batched
        engine): a fresh lane engine with the snapshot's host state, the
        lane's generator from its "rng" (where the generator takes it; see
        snapshot.check_rng), and lane b's rows of the stacked arenas. Other
        lanes and the shared decode scratch are left alone."""
        from ..ops.quant import lane
        from .snapshot import check_rng, restore_arena, restore_host, takes_rng

        assert self._inflight is None, "restore_lane mid-round"
        check_rng(snap, self.generators[b], self.sampling.do_sample)
        eng = self._lane_engine()
        restore_host(eng, snap)
        if takes_rng(snap, self.generators[b]):
            self.generators[b].set_state(torch.from_numpy(np.array(snap["rng"], np.uint8)))
        restore_arena(lane(self.k_arena, b), lane(self.v_arena, b), self.ids_arena[b], snap)
        self.engines[b] = eng


def p_high_water(ms: MultiStreamEngine, b: int, prep: Dict, max_new: int) -> int:
    """Lane b's decode-delta high-water mark (as _prepare_chunk's)."""
    return ms.engines[b].cached + prep["n_real"] + max_new
