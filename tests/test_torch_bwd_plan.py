"""K1-bwd's schedule (csrc/attention_bwd.cu, which derives it on the card;
its index math copied here, `attention_bwd_schedule`, over the row tiles of
ops/attention.py `attention_bwd_tiles`) as a plain model on the CPU, at
Qwen2.5-VL-7B's
widths (H 28, Hkv 4: G = 7) and 3B's (H 16, Hkv 2: G = 8):

- every (key block, row tile) pair of the causal triangle is visited once,
  each CTA's row tiles from the last one down to the diagonal's;
- each row tile's dQ partials fold in one fixed order (key block 0, 1, ...),
  and a CTA waits only on a CTA that took an earlier ticket;
- a tiled model of the algebra in the kernel's order, P and dS rounded to
  bf16 where the kernel rounds them and dQ folded as the counters order it,
  agrees with `train_attention_bwd_plain` within the card's tolerance;
- a simulation of the schedule on 132 SMs puts its makespan near the ideal
  (the triangle's tiles over the SMs), where ascending tile order or a
  descending fold would not.

The kernel runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it to the same tolerance)."""

import heapq
import math
from collections import Counter
from typing import NamedTuple

import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu_torch.ops import attention as A

WIDTHS = {7: (28, 4), 8: (16, 2)}  # G -> (H, Hkv): Qwen2.5-VL-7B, -3B
HD = 128
BN = A.BWD_BLOCK_KEYS
TOL = 2.0**-6  # chip_smoke.py BWD_TOL: two bf16 ulps, of each value and of the largest
SMS = 132  # an H100's SMs


class BwdSchedule(NamedTuple):
    """K1-bwd's schedule: row tiles of `tile_tokens` = 64 // G whole tokens
    (`n_tiles` of them), key blocks of 128 (`n_blocks`), and `jobs` in
    ticket order (the order CTAs start in), one CTA each: (key block n, kv
    head, the row tiles it visits, in order: the last one down to the
    first that reaches key n * 128)."""

    tile_tokens: int
    n_tiles: int
    n_blocks: int
    jobs: list


def attention_bwd_schedule(T: int, G: int, Hkv: int) -> BwdSchedule:
    """The kernel's index math: job j = n Hkv + kv head (n = key block),
    its tiles M - 1 down to n * 128 // tile_tokens."""
    bt, n_tiles = A.attention_bwd_tiles(T, G)
    n_blocks = -(-T // BN)
    jobs = [(n, kvh, range(n_tiles - 1, n * BN // bt - 1, -1))
            for n in range(n_blocks) for kvh in range(Hkv)]
    return BwdSchedule(bt, n_tiles, n_blocks, jobs)


def _last_block(T: int, bt: int, m: int) -> int:
    """The last key block row tile m reaches (its last token's)."""
    return (min(T, (m + 1) * bt) - 1) // BN


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [1, 63, 200, 640, 8192])
def test_schedule_visits_the_causal_triangle_once(T, G):
    Hkv = WIDTHS[G][1]
    sch = attention_bwd_schedule(T, G, Hkv)
    bt = sch.tile_tokens
    assert bt * G <= A.BWD_TILE_ROWS < (bt + 1) * G
    assert sch.n_tiles * bt >= T > (sch.n_tiles - 1) * bt
    seen = Counter()
    for n, kvh, tiles in sch.jobs:
        tiles = list(tiles)
        assert tiles == list(range(sch.n_tiles - 1, tiles[-1] - 1, -1))  # the last tile down
        # the diagonal's tile is the first that reaches the block's first key
        assert _last_block(T, bt, tiles[-1]) >= n and (tiles[-1] == 0 or
                                                       _last_block(T, bt, tiles[-1] - 1) < n)
        seen.update((kvh, n, m) for m in tiles)
    triangle = {(kvh, n, m) for kvh in range(Hkv) for m in range(sch.n_tiles)
                for n in range(_last_block(T, bt, m) + 1)}
    assert set(seen) == triangle and set(seen.values()) == {1}


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [1, 63, 200, 640, 8192])
def test_fold_order_is_fixed_and_waits_are_on_earlier_tickets(T, G):
    """The block-n CTA folds row tile m once the tile's counter reads n,
    and each fold adds one: so a tile's folders must be blocks 0 .. k - 1
    (else the counter never reaches one of them) and fold in that order,
    whatever the timing. The CTA it waits on (block n - 1, same kv head)
    holds an earlier ticket, so it is already running."""
    Hkv = WIDTHS[G][1]
    sch = attention_bwd_schedule(T, G, Hkv)
    ticket = {(n, kvh): i for i, (n, kvh, _) in enumerate(sch.jobs)}
    assert sorted(ticket.values()) == list(range(Hkv * sch.n_blocks))
    folders = {}
    for n, kvh, tiles in sch.jobs:
        for m in tiles:
            folders.setdefault((kvh, m), []).append(n)
            if n > 0:
                assert ticket[(n - 1, kvh)] < ticket[(n, kvh)]
    for (kvh, m), ns in folders.items():
        assert sorted(ns) == list(range(_last_block(T, sch.tile_tokens, m) + 1))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def bwd_by_schedule(q, k, v, o, lse2, do):
    """K1-bwd's algebra in the kernel's order: per job (key block, kv head)
    the row tiles as it visits them, S and dP in f32 from the bf16 inputs,
    P and dS rounded to bf16 for the products (the kernel's A fragments and
    its dS in shared memory), dK and dV summed over the block's tiles in
    f32; each tile's dQ partials folded in f32 in the order its counter
    admits them (the first stored, the rest added). Outputs rounded to
    bf16, dQ and dK times the softmax scale."""
    T, H, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    sch = attention_bwd_schedule(T, G, Hkv)
    bt = sch.tile_tokens
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dsum = (dof * o.float()).sum(-1)  # [T, H]
    parts = {}
    dk = torch.zeros(T, Hkv, hd)
    dv = torch.zeros(T, Hkv, hd)
    for n, kvh, tiles in sch.jobs:
        keys = torch.arange(n * BN, min(T, n * BN + BN))
        kb, vb = kf[keys, kvh], vf[keys, kvh]
        dka, dva = torch.zeros(len(keys), hd), torch.zeros(len(keys), hd)
        for m in tiles:
            toks = torch.arange(m * bt, min(T, m * bt + bt))
            heads = slice(kvh * G, kvh * G + G)
            qt, dot = qf[toks, heads].reshape(-1, hd), dof[toks, heads].reshape(-1, hd)
            lt, dt = lse2[toks, heads].reshape(-1), dsum[toks, heads].reshape(-1)
            vis = keys[:, None] <= toks.repeat_interleave(G)[None, :]
            st = kb @ qt.T  # S^T [keys, rows]
            pt = torch.where(vis, torch.exp2(st * (A.LOG2E * scale) - lt), 0.0)
            dst = torch.where(vis, pt * (vb @ dot.T - dt), 0.0)
            dva += _bf16(pt) @ dot
            dka += _bf16(dst) @ qt
            parts.setdefault((kvh, m), []).append((n, _bf16(dst).T @ kb))
        dk[keys, kvh], dv[keys, kvh] = dka * scale, dva
    dq = torch.zeros(T, H, hd)
    for (kvh, m), ps in parts.items():
        counter, acc = 0, None
        while counter < len(ps):  # the CTA whose block the counter names folds next
            part = next(p for n, p in ps if n == counter)
            acc = part if acc is None else acc + part
            counter += 1
        toks = torch.arange(m * bt, min(T, m * bt + bt))
        dq[toks, kvh * G:kvh * G + G] = (acc * scale).reshape(len(toks), G, hd)
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [63, 64, 200])
def test_tiled_model_matches_the_plain_algebra(T, G):
    """At T = 63 and 64 the row tiles end on a token boundary at G = 7 and
    8 respectively, at 200 neither does. (At T = 1 the exact dQ and dK are
    0: both sides are f32 rounding of D - dP, which no relative limit can
    compare.)"""
    H, Hkv = WIDTHS[G]
    rng = np.random.default_rng(T * 10 + G)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16)
                   for s in ((T, H, HD), (T, Hkv, HD), (T, Hkv, HD), (T, H, HD)))
    with torch.no_grad():
        o, lse2 = A.train_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    o = o.reshape(T, H, HD).to(torch.bfloat16)
    got = bwd_by_schedule(q, k, v, o, lse2, do)
    want = A.train_attention_bwd_plain(q, k, v, o, lse2, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL * float(b.abs().max()), rtol=TOL)


def makespan(T, G, Hkv, *, tiles_up=False, fold_down=False, fold=0.3):
    """Simulated time of the main kernel, a row tile's products 1 unit, a
    fold `fold` units, one CTA an SM: CTAs start in ticket order as SMs
    free; a CTA stores a tile's dQ partial into one of 2 buffers (its
    products wait for the buffer's last fold) and folds it once the tile's
    previous folder has. Shipped: tiles from the last down, fold by block
    0, 1, ... (tickets by block ascending). tiles_up: tiles from the
    diagonal up. fold_down: fold by the last block first (each CTA waits on
    block n + 1, so tickets must hand out the lightest blocks first)."""
    sch = attention_bwd_schedule(T, G, Hkv)
    bt = sch.tile_tokens
    jobs = sch.jobs
    if fold_down:
        jobs = sorted(jobs, key=lambda j: (-j[0], j[1]))
    done = {}  # (n, kvh, m) -> the fold's end
    free = [0.0] * SMS
    end = 0.0
    for n, kvh, tiles in jobs:
        t = heapq.heappop(free)
        order = list(tiles)[::-1] if tiles_up else list(tiles)
        folds = []
        for i, m in enumerate(order):
            t = max(t + 1.0, folds[i - 2] if i >= 2 else 0.0)
            prev = n + 1 if fold_down else n - 1
            after = done.get((prev, kvh, m), 0.0) if 0 <= prev <= _last_block(T, bt, m) else 0.0
            folds.append(max(t, after) + fold)
            done[(n, kvh, m)] = folds[-1]
        heapq.heappush(free, folds[-1])
        end = max(end, folds[-1])
    return end, sum(len(tiles) for _, _, tiles in jobs) / SMS


def test_schedule_makespan_is_near_the_ideal():
    """At slice M's shape (T = 8192, G = 7, Hkv 4: 256 CTAs, block 0's 911
    row tiles about the ideal share of 898) the shipped order ends within
    5% of the ideal; the two alternatives take 1.3x it or more."""
    shipped, ideal = makespan(8192, 7, 4)
    assert shipped <= 1.05 * ideal
    assert makespan(8192, 7, 4, tiles_up=True)[0] >= 1.3 * ideal
    assert makespan(8192, 7, 4, fold_down=True)[0] >= 1.3 * ideal
