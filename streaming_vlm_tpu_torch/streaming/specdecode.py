"""Speculative decoding over the streaming engine, in PyTorch.

Port of streaming_vlm_tpu/streaming/specdecode.py (deterministic-draft
speculative sampling; acceptance rates need real weights, so nothing here
claims a rate or a speed-up):

  * a host-side draft proposes up to k tokens from the committed context
    (`NGramDraft`, `FixedDraft`, or any callable(context_ids, k) -> ids);
  * `spec_verify_step` forwards [pending, d_1 .. d_k] (T = k_pad = k + 1)
    over the pre-rotated arena + decode delta in one pass of the decoder
    stack, its attention kernel K2-verify (`ops.attention.
    streaming_verify_attention`), computes the logits at every position
    and runs the acceptance rule on the device (`accept_tokens`): only the
    emitted ids, n_emit, n_keep and done cross to the host, once a round;
  * greedy: accept d_j while it equals the penalised argmax, so the emitted
    tokens are the autoregressive stream's; sampling: accept d_j with
    probability p(d_j), else draw from the residual (p with p[d_j] zeroed),
    which emits tokens distributed as autoregressive sampling;
  * the pending token's and the accepted drafts' K/V are valid and land in
    the decode delta; rejected rows are overwritten by the next round. The
    final pending token never gets K/V: it re-prefills with the next chunk
    through the engine's `uncached_tail`, as the forced <|im_end|> does.

`spec_prefill_step` is the chunk step's prefill (`engine.prefill_lanes`,
shared with `chunk_step_batched`) plus the first sampled token.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.qwen25_vl import language, model as vlm
from ..ops.quant import Arena, with_lanes, write_slots
from ..ops.sampling import apply_repetition_penalty, sample_tokens
from .engine import _eos_gate, _lane_ints, prefill_lanes


@dataclasses.dataclass(frozen=True)
class SpecStatics:
    cfg: ModelConfig
    t_pad: int
    k_pad: int  # verify width: 1 pending + (k_pad - 1) draft slots
    n_delta: int  # decode-delta rows (max_new + k_pad)
    temperature: float
    repetition_penalty: float
    do_sample: bool
    max_new: int
    eos_threshold: Optional[Tuple[int, float, float]] = None
    use_descriptors: bool = False


@torch.no_grad()
def spec_prefill_step(
    statics: SpecStatics,
    model: vlm.Qwen25VL,
    k_arena: Arena,  # [L, C, Hkv, hd] (float or QuantKV), updated in place
    v_arena: Arena,
    slot_positions,  # [3, C] f32, or the descriptor dict of device tensors
    tokens: torch.Tensor,  # [t_pad] int64 on the device (padded)
    vis_embeds: Optional[torch.Tensor],  # [N_vis, D] or None
    vis_slots,  # [N_vis] host ints: rows within the chunk
    ids_arena: torch.Tensor,  # [C] int64, updated in place
    insert_at: int,
    n_real: int,
    generator: Optional[torch.Generator],
):
    """The chunk prefill (the chunk step's, over the pre-rotated arena) and
    the first sampled token. Returns (k_rot [L, C, Hkv, hd]: the rotated K
    copy including the chunk's block, which the verify rounds read;
    pending0, a 0-d int64; presence [V] bool with pending0 set; delta_pos
    [3, n_delta]: the decode delta's positions), all on the device."""
    dev = ids_arena.device
    (insert_at, n_real), (ins_d, nreal_d) = _lane_ints(([insert_at], [n_real]), dev)
    pos = ({k: v[None] for k, v in slot_positions.items()} if statics.use_descriptors
           else slot_positions[None])
    pre = prefill_lanes(
        statics.cfg, model, with_lanes(k_arena), with_lanes(v_arena), pos, tokens[None],
        None if vis_embeds is None else vis_embeds[None],
        None if vis_slots is None else np.asarray(vis_slots)[None],
        ids_arena[None], insert_at, ins_d, nreal_d, ins_d + nreal_d, t_pad=statics.t_pad,
        use_descriptors=statics.use_descriptors, prerotate=True, rot_quant="none",
    )
    logits = pre.logits
    if statics.eos_threshold is not None:
        logits = _eos_gate(logits, statics.eos_threshold, 0)
    presence = pre.presence
    pending0 = sample_tokens(
        [generator], logits, presence, temperature=statics.temperature,
        repetition_penalty=statics.repetition_penalty, do_sample=statics.do_sample,
    )
    presence.scatter_(1, pending0[:, None], True)
    base = insert_at[0] + n_real[0]
    delta_pos = pre.slot_positions[0, :, base : base + statics.n_delta]
    return pre.k_rot[0], pending0[0], presence[0], delta_pos


def accept_tokens(
    statics: SpecStatics,
    logits_all: torch.Tensor,  # [K, V] f32: the target's logits at the K inputs
    inputs: torch.Tensor,  # [K] int64: pending, then the draft (padded)
    presence: torch.Tensor,  # [V] bool, updated in place in emission order
    n_draft: int,  # valid proposals
    emitted_total: int,  # tokens emitted in this chunk before the round
    eos_id: int,
    uniforms: Optional[torch.Tensor] = None,  # [K] in [0, 1): acceptance draws (sampling)
    gumbel: Optional[torch.Tensor] = None,  # [K, V]: Gumbel noise of the resamples (sampling)
    gaps: Optional[List[torch.Tensor]] = None,
):
    """The acceptance rule of one round, on the device, position by
    position: the eos threshold gate at its per-position step, the
    repetition penalty over the presence mask as it stands after the
    tokens before, then greedy (accept d_j while it equals the argmax) or
    speculative sampling (accept d_j if uniforms[j] < p(d_j), else the
    Gumbel-max draw `gumbel[j]` from the residual, p with p(d_j) zeroed),
    never past max_new tokens in the chunk. Returns (emitted [K], n_emit,
    n_keep, done), device tensors: the first n_emit of emitted are this
    round's tokens; n_keep delta rows (the pending token's and each
    accepted draft's) hold valid K/V. With `gaps` (a list), each
    position's [top-two gap of the penalised logits, max |logit|] is
    appended to it (observability: how close a greedy choice was)."""
    K, V = logits_all.shape
    dev = logits_all.device
    eos = torch.tensor(eos_id, dtype=torch.long, device=dev)
    vocab = torch.arange(V, device=dev)
    still = torch.ones((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    toks: List[torch.Tensor] = []
    emits: List[torch.Tensor] = []
    accs: List[torch.Tensor] = []
    for j in range(K):
        logits = logits_all[j]
        if statics.eos_threshold is not None:
            logits = _eos_gate(logits[None], statics.eos_threshold, emitted_total + j)[0]
        scores = apply_repetition_penalty(logits, presence, statics.repetition_penalty)
        if gaps is not None:
            top = torch.topk(scores, 2).values
            gaps.append(torch.stack([top[0] - top[1], logits.abs().max()]))
        d = inputs[j + 1] if j < K - 1 else eos
        is_draft = j < n_draft
        if statics.do_sample:
            probs = torch.softmax(scores / max(statics.temperature, 1e-6), dim=-1)
            accept = (uniforms[j] < probs.gather(0, d.view(1))[0]) if is_draft \
                else torch.zeros_like(still)
            resid = torch.where(vocab == d, 0.0, probs) if is_draft else probs
            sampled = torch.argmax(torch.log(resid.clamp_min(1e-30)) + gumbel[j])
            tok = torch.where(accept, d, sampled)
        else:
            tok = torch.argmax(scores)
            accept = (tok == d) if is_draft else torch.zeros_like(still)
        # budget: never emit past max_new in total
        can_emit = still & ~done if emitted_total + j < statics.max_new else torch.zeros_like(still)
        tok = torch.where(can_emit, tok, eos)
        # (1-element index tensors: a 0-d one would be read on the host)
        presence.index_put_((tok.view(1),), presence.gather(0, tok.view(1)) | can_emit)
        now_done = done | (can_emit & (tok == eos))
        # accept on only while this position was an emitted, accepted draft
        # (a rejection emits the bonus token and stops)
        still = still & accept & can_emit & ~now_done
        done = now_done
        toks.append(tok)
        emits.append(can_emit)
        accs.append(accept & can_emit)
    n_emit = torch.stack(emits).sum()
    n_keep = 1 + torch.stack(accs).sum()
    return torch.stack(toks), n_emit, n_keep, done


@torch.no_grad()
def spec_verify_step(
    statics: SpecStatics,
    model: vlm.Qwen25VL,
    k_rot: torch.Tensor,  # [L, C, Hkv, hd] read-only (rotated, chunk included)
    v_arena: Arena,  # read-only
    dk: torch.Tensor,  # [L, n_delta, Hkv, hd], updated in place
    dkr: torch.Tensor,
    dv: torch.Tensor,
    presence: torch.Tensor,  # [V] bool, updated in place
    inputs: torch.Tensor,  # [k_pad] int64 on the device: pending, then the draft (padded)
    n_draft: int,
    n_delta_cur: int,  # valid delta rows
    decode_base: int,  # arena slots < decode_base are visible
    emitted_total: int,
    delta_pos: torch.Tensor,  # [3, n_delta]
    eos_id: int,
    generator: Optional[torch.Generator],
    gaps: Optional[List[torch.Tensor]] = None,  # accept_tokens' observability list
) -> torch.Tensor:
    """One speculative round: forward the k_pad inputs over the arena and
    the delta rows < n_delta_cur (K2-verify; K2 at k_pad == 1), write
    their K/V into the delta at n_delta_cur, accept on the device.
    Sampling draws its k_pad uniforms, then its [k_pad, V] resample noise,
    from `generator`. Returns one int64 tensor [k_pad + 3]: the emitted ids
    (padded), n_emit, n_keep, done."""
    tcfg = statics.cfg.text
    lm = model.text
    K = statics.k_pad
    pos = delta_pos[:, n_delta_cur : n_delta_cur + K]
    emb = language.embed_tokens(tcfg, lm, inputs)
    hidden, (k1, k1r, v1) = language.language_forward_streaming(
        tcfg, lm, emb, pos, arena=(k_rot, v_arena), arena_rotated=True,
        visible_len=decode_base, extra=(dkr, dv), extra_visible=n_delta_cur,
    )
    logits_all = language.lm_logits(tcfg, lm, hidden)  # [K, V]
    rows = slice(n_delta_cur, n_delta_cur + K)
    dk[:, rows], dkr[:, rows], dv[:, rows] = k1, k1r, v1
    uniforms = gumbel = None
    if statics.do_sample:
        dev = logits_all.device
        uniforms = torch.rand(K, generator=generator, device=dev)
        u = torch.rand(K, logits_all.shape[1], generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u))
    emitted, n_emit, n_keep, done = accept_tokens(
        statics, logits_all, inputs, presence, n_draft, emitted_total, eos_id, uniforms, gumbel,
        gaps)
    return torch.cat([emitted, torch.stack([n_emit, n_keep, done.long()])])


@torch.no_grad()
def spec_commit_step(k_arena: Arena, v_arena: Arena, ids_arena: torch.Tensor, dk: torch.Tensor,
                     dv: torch.Tensor, emitted: torch.Tensor, decode_base: int) -> None:
    """Merge the decode delta and the emitted ids [n_delta] into the arena
    at decode_base, in place (quantized per slot into an int8 arena); the
    rows past the committed ones are invisible."""
    write_slots(k_arena, dk, decode_base)
    write_slots(v_arena, dv, decode_base)
    ids_arena[decode_base : decode_base + emitted.shape[0]] = emitted


# ---------------------------------------------------------------------------
# Host-side drafts
# ---------------------------------------------------------------------------


class NGramDraft:
    """Suffix-match draft: find the most recent earlier occurrence of the
    last `n` committed tokens and propose its continuation. Zero model
    cost; works when commentary repeats phrases. Returns fewer than k
    proposals (possibly none) when no match exists."""

    def __init__(self, n: int = 2, history_limit: int = 8192):
        self.n = n
        self.history_limit = history_limit
        self._hist: list = []

    def observe(self, ids) -> None:
        self._hist.extend(int(t) for t in np.asarray(ids).reshape(-1))
        if len(self._hist) > self.history_limit:
            self._hist = self._hist[-self.history_limit :]

    def __call__(self, context_ids: np.ndarray, k: int) -> np.ndarray:
        hist = self._hist + [int(t) for t in np.asarray(context_ids).reshape(-1)]
        n = self.n
        if len(hist) < n + 1:
            return np.zeros(0, np.int32)
        key = hist[-n:]
        # scan backwards for the most recent earlier match
        for i in range(len(hist) - n - 1, n - 1, -1):
            if hist[i - n : i] == key:
                return np.asarray(hist[i : i + k], np.int32)
        return np.zeros(0, np.int32)


class FixedDraft:
    """Test draft: replays a fixed token sequence, aligned by the longest
    prefix of it that already ends the context (clairvoyant when fed the
    autoregressive output; adversarial when fed garbage)."""

    def __init__(self, tokens):
        self.tokens = [int(t) for t in np.asarray(tokens, np.int32).reshape(-1)]

    def observe(self, ids) -> None:
        pass

    def __call__(self, context_ids: np.ndarray, k: int) -> np.ndarray:
        ctx = [int(t) for t in np.asarray(context_ids).reshape(-1)]
        toks = self.tokens
        for i in range(len(toks), -1, -1):
            if i <= len(ctx) and (i == 0 or ctx[-i:] == toks[:i]):
                return np.asarray(toks[i : i + k], np.int32)
        return np.zeros(0, np.int32)
