"""Segment table: the host-side source of truth for the streaming KV policy.

A numpy copy of streaming_vlm_tpu/streaming/segments.py (whose import of
the JAX rope module pulls in jax), held bitwise equal to it by
tests/test_torch_host.py.

The reference discovers conversation structure by scanning token-id patterns
every round (get_qwen_range, /root/reference/src/streaming_vlm/utils/
get_qwen_range.py:15) and then performs KV surgery with torch.cat /
index_select per layer (inference.py:50-172). Here the orchestrator *emits*
segments when it builds prompts, so structure is always known; eviction is a
segment-list edit that yields ONE gather index array for the device-side
arena compaction (static shapes, one jitted gather per chunk).

Eviction semantics replicated (reference process_past_kv, inference.py:87-172):
  * round i >= text_round: the oldest surviving assistant body (minus the
    " ...<|im_end|>" tail) is RELOCATED into the long-lived "previous text"
    region (resort_id_and_kv, :100-121), then its scaffolding is pruned.
  * round i >= visual_round: the oldest vision block is pruned.
  * round i >= max(both): the whole user turn of that round is pruned.
  * every round > 0: the previous-text body keeps only its first `text_sink`
    and last `text_sliding_window - 1` tokens (:162-169; the reference's
    index arithmetic keeps window-1 body tokens — replicated exactly).

One deliberate deviation: with exactly one of sink/window set to None the
reference's index arithmetic deletes the `<|im_end|>`/newline framing of the
previous-text turn (corrupting the format); we clamp to the framing instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.qwen25_vl.rope import PosSegment, mrope_positions_from_segments

# segment kinds
SYSTEM = "system"
PREV_HEADER = "prev_header"  # \n<|im_start|>previous text\n
PREV_BODY = "prev_body"
PREV_FOOTER = "prev_footer"  # <|im_end|>
SEP = "sep"  # a turn-separator \n that is never pruned
SEP_AFTER_USER = "sep_after_user"  # the \n after user(r)'s im_end; dies with user(r)
SEP_AFTER_ASST = "sep_after_asst"  # the \n after assistant(r)'s im_end; dies with assistant(r)
USER_OPEN = "user_open"  # <|im_start|>user\n
USER_TIME = "user_time"  # Time=a-bs
VIS_OPEN = "vis_open"  # <|vision_start|>
VISION = "vision"  # video_pad * n
VIS_CLOSE = "vis_close"  # <|vision_end|>
QUERY = "query"  # round-0 query text
USER_CLOSE = "user_close"  # <|im_end|>
ASST_OPEN = "asst_open"  # <|im_start|>assistant\n
ASST_BODY = "asst_body"  # generated text minus the " ...<|im_end|>" tail
ASST_TAIL = "asst_tail"  # " ..." + <|im_end|>

# NOTE on separators: the reference's contain_lf scanning attributes the \n
# FOLLOWING a turn's <|im_end|> to that turn, so pruning assistant(r) removes
# assistant(r)'s scaffolding plus the \n that separates it from user(r+1)
# (get_qwen_range.py:72-75). The surviving token *ids* would be identical if
# we deleted the leading \n instead — but the surviving KV row would be a
# different token instance, computed under different context. The SEP_AFTER_*
# kinds pin the exact instance semantics.


@dataclasses.dataclass
class Seg:
    kind: str
    ids: np.ndarray  # int32 token ids
    round: int = -1  # chunk round this segment belongs to; -1 = stream-level
    grid_thw: Optional[Tuple[int, int, int]] = None
    second_per_grid_t: float = 1.0

    def __len__(self) -> int:
        return int(self.ids.shape[0])


@dataclasses.dataclass
class EvictionPlan:
    """Result of a table edit: gather old arena slots `src` into slots
    [0, len(src)) of the new arena. `changed` is False when the table was
    left untouched (no gather needed)."""

    src: np.ndarray  # int32 [new_len] old-slot index per new slot
    changed: bool


class SegmentTable:
    def __init__(self, all_text: bool = False):
        self.segs: List[Seg] = []
        self.all_text = all_text

    # ------------------------------------------------------------------ basics
    def total_len(self) -> int:
        return sum(len(s) for s in self.segs)

    def token_ids(self) -> np.ndarray:
        if not self.segs:
            return np.zeros(0, np.int32)
        return np.concatenate([s.ids for s in self.segs]).astype(np.int32)

    def vision_mask(self) -> np.ndarray:
        """Boolean mask over all tokens: True for tokens of VISION segments.

        Used instead of raw `ids == video_pad` matching when locating the
        chunk's vision-embed scatter slots: the re-prefilled uncached tail
        contains GENERATED tokens, and a sampled token that happens to be the
        video_pad id must not claim an embed row. (The reference raw-matches
        and raises a count mismatch in that case — model_forward.py:81-93;
        segment provenance makes the degenerate case well-defined.)"""
        out = np.zeros(self.total_len(), bool)
        off = 0
        for s in self.segs:
            if s.kind == VISION:
                out[off : off + len(s)] = True
            off += len(s)
        return out

    def append(self, seg: Seg) -> None:
        if len(seg):
            self.segs.append(seg)
        elif seg.kind in (PREV_BODY,):
            # keep empty prev_body as an anchor for relocation
            self.segs.append(seg)

    def positions(self, *, spatial_merge_size: int, tokens_per_second: float) -> np.ndarray:
        """Contiguous mRoPE positions [3, L] over the current table — the
        "shrink" re-index (reference model_forward.py:101-110)."""
        pos_segs = []
        for s in self.segs:
            if s.kind == VISION and not self.all_text:
                pos_segs.append(
                    PosSegment(
                        "video",
                        len(s),
                        grid_thw=s.grid_thw,
                        second_per_grid_t=s.second_per_grid_t,
                    )
                )
            else:
                pos_segs.append(PosSegment("text", len(s)))
        return mrope_positions_from_segments(
            pos_segs,
            spatial_merge_size=spatial_merge_size,
            tokens_per_second=tokens_per_second,
        )

    def position_descriptors(
        self,
        *,
        spatial_merge_size: int,
        tokens_per_second: float,
        extra_text: int = 0,
        max_segs: Optional[int] = None,
    ):
        """Compact per-segment descriptor table from which the device can
        rebuild the full [3, C] position tensor (engine ships ~2 KB instead of
        [3, C] f32). Returns a dict of fixed-size numpy arrays plus
        (n_segs, total_len, next_pos). `extra_text` appends a virtual text
        segment (the decode slots)."""
        starts, bases, kinds, ghs, gws, tsteps = [], [], [], [], [], []
        acc = 0
        next_start = 0.0
        merged: List = []  # coalesce adjacent text segments
        for s in self.segs:
            if s.kind == VISION and not self.all_text:
                merged.append(s)
            elif merged and isinstance(merged[-1], int):
                merged[-1] += len(s)
            else:
                merged.append(len(s))
        if extra_text:
            if merged and isinstance(merged[-1], int):
                merged[-1] += extra_text
            else:
                merged.append(extra_text)

        for item in merged:
            if isinstance(item, int):
                if item == 0:
                    continue
                starts.append(acc)
                bases.append(next_start)
                kinds.append(0)
                ghs.append(1)
                gws.append(1)
                tsteps.append(1.0)
                acc += item
                next_start += item
            else:
                t, h, w = item.grid_thw
                gh = h // spatial_merge_size
                gw = w // spatial_merge_size
                tstep = item.second_per_grid_t * tokens_per_second
                starts.append(acc)
                bases.append(next_start)
                kinds.append(1)
                ghs.append(gh)
                gws.append(gw)
                tsteps.append(float(tstep))
                n = t * gh * gw
                block_max = max((t - 1) * tstep if t > 1 else 0.0, gh - 1, gw - 1)
                acc += n
                next_start = next_start + block_max + 1.0
        n_segs = len(starts)
        if max_segs is None:
            # auto-size to the next power-of-two bucket (min 256) so unbounded
            # configs — e.g. the full-attention ablation, which accumulates
            # segments for the whole stream — never trip a fixed cap; shape
            # changes recompile O(log n_segs) times over a stream's lifetime
            max_segs = 256
            while max_segs < n_segs:
                max_segs *= 2
        if n_segs > max_segs:
            raise ValueError(
                f"{n_segs} descriptor segments exceed max_segs={max_segs}; "
                f"pass max_segs=None to auto-size"
            )

        def pad(arr, dtype, fill=0):
            out = np.full(max_segs, fill, dtype)
            out[: len(arr)] = arr
            return out

        desc = {
            "starts": pad(starts, np.int32, fill=2**30),
            "bases": pad(bases, np.float32),
            "kinds": pad(kinds, np.int32),
            "ghs": pad(ghs, np.int32, fill=1),
            "gws": pad(gws, np.int32, fill=1),
            "tsteps": pad(tsteps, np.float32, fill=1.0),
        }
        return desc, n_segs, acc, next_start

    # ------------------------------------------------------------------ eviction
    def _offsets(self) -> List[int]:
        offs, acc = [], 0
        for s in self.segs:
            offs.append(acc)
            acc += len(s)
        return offs

    def _find(self, kind: str, rnd: int) -> Optional[int]:
        for i, s in enumerate(self.segs):
            if s.kind == kind and s.round == rnd:
                return i
        return None

    def evict(
        self,
        chunk_index: int,
        *,
        text_round: int,
        visual_round: int,
        text_sink: Optional[int],
        text_sliding_window: Optional[int],
    ) -> EvictionPlan:
        """Apply the round-`chunk_index` eviction policy BEFORE ingesting that
        chunk. Mutates the table; returns the arena gather plan."""
        offs = self._offsets()
        old_ranges = {id(s): (offs[i], len(s)) for i, s in enumerate(self.segs)}

        # each new-table entry is (seg, src_ranges) where src_ranges is a list
        # of (old_start, length) covering the seg's ids in order
        changed = False

        def rng_of(s: Seg) -> List[Tuple[int, int]]:
            o, n = old_ranges[id(s)]
            return [(o, n)] if n else []

        # ---- 1. relocate oldest surviving assistant body into prev_body
        if chunk_index >= text_round:
            victim = chunk_index - text_round
            bi = self._find(ASST_BODY, victim)
            prev_i = next(
                (i for i, s in enumerate(self.segs) if s.kind == PREV_BODY), None
            )
            assert prev_i is not None, "stream must have a previous-text region"
            if bi is not None:
                body = self.segs[bi]
                prev = self.segs[prev_i]
                assert prev_i < bi
                # merge: prev_body ids += body ids; record both src ranges
                merged = Seg(
                    PREV_BODY, np.concatenate([prev.ids, body.ids]).astype(np.int32)
                )
                merged_ranges = rng_of(prev) + rng_of(body)
                old_ranges[id(merged)] = None  # sentinel; handled via merged_ranges
                self._merged_ranges = {id(merged): merged_ranges}
                self.segs[prev_i] = merged
                del self.segs[bi]
                changed = True
            else:
                self._merged_ranges = {}

            # ---- prune assistant scaffolding of that round, incl. its
            # trailing separator (contain_lf semantics)
            for kind in (ASST_OPEN, ASST_TAIL, SEP_AFTER_ASST):
                j = self._find(kind, victim)
                if j is not None:
                    del self.segs[j]
                    changed = True

            # ---- prune that round's Time text when vision outlives text
            if visual_round > text_round:
                j = self._find(USER_TIME, victim)
                if j is not None:
                    del self.segs[j]
                    changed = True
        else:
            self._merged_ranges = {}

        # ---- 2. prune oldest vision block
        if chunk_index >= visual_round and visual_round < text_round:
            victim = chunk_index - visual_round
            for kind in (VIS_OPEN, VISION, VIS_CLOSE):
                j = self._find(kind, victim)
                if j is not None:
                    del self.segs[j]
                    changed = True

        # ---- 3. prune the whole user turn once both policies have expired it
        if chunk_index >= max(visual_round, text_round):
            victim = chunk_index - max(visual_round, text_round)
            for kind in (
                USER_OPEN,
                USER_TIME,
                VIS_OPEN,
                VISION,
                VIS_CLOSE,
                QUERY,
                USER_CLOSE,
                SEP_AFTER_USER,
            ):
                j = self._find(kind, victim)
                if j is not None:
                    del self.segs[j]
                    changed = True

        # ---- 4. previous-text sink + sliding window cut
        if chunk_index > 0 and (text_sink is not None or text_sliding_window is not None):
            sink = text_sink if text_sink is not None else 0
            win = text_sliding_window if text_sliding_window is not None else 1
            prev_i = next(
                (i for i, s in enumerate(self.segs) if s.kind == PREV_BODY), None
            )
            if prev_i is not None:
                prev = self.segs[prev_i]
                B = len(prev)
                # reference arithmetic keeps first `sink` and last `win - 1`
                # body tokens, and only cuts when B >= sink + win
                if B >= sink + win:
                    keep_tail = win - 1
                    ranges = self._merged_ranges.get(id(prev)) or rng_of(prev)
                    head = _slice_ranges(ranges, 0, sink)
                    tail = _slice_ranges(ranges, B - keep_tail, B)
                    new_ids = np.concatenate(
                        [prev.ids[:sink], prev.ids[B - keep_tail :]]
                    ).astype(np.int32)
                    cut = Seg(PREV_BODY, new_ids)
                    self._merged_ranges = {id(cut): head + tail}
                    self.segs[prev_i] = cut
                    changed = True

        # ---- build gather plan
        src_parts: List[np.ndarray] = []
        for s in self.segs:
            ranges = self._merged_ranges.get(id(s)) if hasattr(self, "_merged_ranges") else None
            if ranges is None:
                ranges = rng_of(s)
            for start, n in ranges:
                src_parts.append(np.arange(start, start + n, dtype=np.int32))
        src = (
            np.concatenate(src_parts) if src_parts else np.zeros(0, np.int32)
        )
        self._merged_ranges = {}
        return EvictionPlan(src=src, changed=changed)


def _slice_ranges(
    ranges: Sequence[Tuple[int, int]], lo: int, hi: int
) -> List[Tuple[int, int]]:
    """Slice a concatenation of (start, len) ranges by logical interval [lo, hi)."""
    out: List[Tuple[int, int]] = []
    acc = 0
    for start, n in ranges:
        s = max(lo, acc)
        e = min(hi, acc + n)
        if e > s:
            out.append((start + (s - acc), e - s))
        acc += n
    return out

