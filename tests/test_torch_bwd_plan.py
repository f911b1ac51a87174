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
  descending fold would not;
- the full-block mode (ring attention's blocks wholly before the queries)
  runs as clusters of two CTAs (key blocks 2c and 2c + 1 of a kv head, an
  odd count's last CTA over keys past T only, which folds an exact 0): it
  visits the whole rectangle of (key block, row tile) pairs once, in the
  same fixed fold order; a CTA waits only on its peer or on a cluster with
  an earlier ticket, so a simulation with only some clusters resident
  still finishes; its tiled model agrees with the plain algebra without
  the mask, and two runs of it are bitwise equal.

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


def attention_bwd_schedule(T: int, G: int, Hkv: int, full: bool = False) -> BwdSchedule:
    """The kernel's index math: job j = n Hkv + kv head (n = key block),
    its tiles M - 1 down to n * 128 // tile_tokens (the full-block mode,
    `full`: down to 0)."""
    bt, n_tiles = A.attention_bwd_tiles(T, G)
    n_blocks = -(-T // BN)
    jobs = [(n, kvh, range(n_tiles - 1, -1 if full else n * BN // bt - 1, -1))
            for n in range(n_blocks) for kvh in range(Hkv)]
    return BwdSchedule(bt, n_tiles, n_blocks, jobs)


class Cluster(NamedTuple):
    """A cluster of the full-block mode, in ticket order: the cluster index
    c of kv head `kvh`, its CTAs' key blocks (rank r: 2c + r; an odd
    count's last cluster's rank 1 has block `n_blocks`, keys past T only)
    and the row tiles both visit, in order."""

    c: int
    kvh: int
    blocks: tuple
    tiles: range


def attention_bwd_clusters(T: int, G: int, Hkv: int) -> list:
    """The full-block kernel's index math: cluster ticket t = c Hkv + kv
    head, taken by rank 0 and read by rank 1; rank r takes key block 2c +
    r; every row tile, the last one down."""
    _, n_tiles = A.attention_bwd_tiles(T, G)
    n_blocks = -(-T // BN)
    out = []
    for ticket in range(Hkv * (-(-n_blocks // 2))):
        c, kvh = ticket // Hkv, ticket % Hkv
        out.append(Cluster(c, kvh, (2 * c, 2 * c + 1), range(n_tiles - 1, -1, -1)))
    return out


def run_clusters(T: int, G: int, Hkv: int, resident: int, tickets=None):
    """Steps to finish the full-block kernel with at most `resident`
    clusters on the card at once, or None on a deadlock. Clusters start in
    ticket order (`tickets`: a permutation of the kernel's, to show a
    deadlock being caught) as slots free; each step, every resident cluster
    folds its next row tile if the tile's count names its rank 0's block
    (2c; its rank 1 folds next, as the count then names 2c + 1), adding
    two; a cluster leaves after its last tile."""
    clusters = attention_bwd_clusters(T, G, Hkv)
    if tickets is not None:
        clusters = [clusters[t] for t in tickets]
    count = Counter()  # (kv head, tile) -> folds done
    queue, running, steps = list(clusters), [], 0
    while queue or running:
        while queue and len(running) < resident:
            running.append([queue.pop(0), 0])
        moved = False
        for job in running:
            cl, i = job
            m = cl.tiles[i]
            if count[(cl.kvh, m)] == cl.blocks[0]:
                count[(cl.kvh, m)] += 2
                job[1] += 1
                moved = True
        running = [job for job in running if job[1] < len(job[0].tiles)]
        if not moved:
            return None
        steps += 1
    return steps


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


def bwd_by_schedule(q, k, v, o, lse2, do, full: bool = False):
    """K1-bwd's algebra in the kernel's order: per job (key block, kv head)
    the row tiles as it visits them, S and dP in f32 from the bf16 inputs,
    P and dS rounded to bf16 for the products (the kernel's A fragments and
    its dS in shared memory), dK and dV summed over the block's tiles in
    f32; each tile's dQ partials folded in f32 in the order its counter
    admits them (the first stored, the rest added). Outputs rounded to
    bf16, dQ and dK times the softmax scale. `full`: the full-block mode
    (every tile, no mask; an odd count's last CTA, over keys past T only,
    adds an exact 0 after the last block, left out here)."""
    T, H, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    sch = attention_bwd_schedule(T, G, Hkv, full)
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
            if full:
                vis = torch.ones_like(vis)
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


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [1, 200, 640, 4096])
def test_full_block_schedule_visits_every_pair_once_in_a_fixed_fold_order(T, G):
    """The full-block mode (ring attention's key blocks wholly before the
    queries): every CTA of every cluster visits every row tile, the last
    one down, so each (key block, row tile) pair once (an odd count's last
    CTA visits keys past T only); each tile folds blocks 0 .. n_blocks - 1
    in that order (its count names the next), cluster c holding blocks 2c
    and 2c + 1."""
    Hkv = WIDTHS[G][1]
    sch = attention_bwd_schedule(T, G, Hkv, full=True)
    clusters = attention_bwd_clusters(T, G, Hkv)
    assert len(clusters) == Hkv * (-(-sch.n_blocks // 2))
    seen = Counter()
    for cl in clusters:
        assert list(cl.tiles) == list(range(sch.n_tiles - 1, -1, -1))
        assert cl.blocks == (2 * cl.c, 2 * cl.c + 1)
        seen.update((cl.kvh, n, m) for n in cl.blocks for m in cl.tiles)
    real = {(kvh, n, m) for kvh in range(Hkv) for n in range(sch.n_blocks)
            for m in range(sch.n_tiles)}
    assert real <= set(seen) and set(seen.values()) == {1}
    past = set(seen) - real  # the odd count's last CTA: its keys start at T or later
    assert {n for _, n, _ in past} <= {sch.n_blocks} and (len(past) > 0) == (sch.n_blocks % 2 == 1)
    assert all(n * BN >= T for _, n, _ in past)
    folders = {}
    for cl in clusters:  # in ticket order, as they start
        for n in cl.blocks:
            if n < sch.n_blocks:
                for m in cl.tiles:
                    folders.setdefault((cl.kvh, m), []).append(n)
    assert all(ns == list(range(sch.n_blocks)) for ns in folders.values())


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [200, 640, 4096])
def test_cluster_waits_only_on_an_earlier_ticket(T, G):
    """Block n folds a tile after block n - 1 of the same kv head: for rank
    1 that is its peer (the cluster's CTAs start together), for rank 0 the
    previous cluster's rank 1, whose ticket is earlier: it was running
    before, so the wait ends."""
    Hkv = WIDTHS[G][1]
    clusters = attention_bwd_clusters(T, G, Hkv)
    ticket = {(cl.c, cl.kvh): t for t, cl in enumerate(clusters)}
    assert sorted(ticket.values()) == list(range(len(clusters)))
    holder = {(n, cl.kvh): (cl.c, cl.kvh) for cl in clusters for n in cl.blocks}
    for (n, kvh), owner in holder.items():
        if n > 0:
            waited = holder[(n - 1, kvh)]
            assert waited == owner if n % 2 else ticket[waited] < ticket[owner]


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [200, 640, 4096])
def test_clusters_finish_with_only_some_resident(T, G):
    """Whatever number of clusters the card holds at once (1, 3, or all of
    them), the full-block kernel's folds finish; handing out the last
    clusters' tickets first, with one resident, would deadlock, and the
    simulation sees it."""
    Hkv = WIDTHS[G][1]
    clusters = attention_bwd_clusters(T, G, Hkv)
    n_tiles = A.attention_bwd_tiles(T, G)[1]
    for resident in (1, 3, len(clusters)):
        steps = run_clusters(T, G, Hkv, resident)
        assert steps is not None and steps >= n_tiles
    if len(clusters) > Hkv:
        backwards = sorted(range(len(clusters)), key=lambda t: -clusters[t].c)
        assert run_clusters(T, G, Hkv, 1, tickets=backwards) is None


def _full_block_inputs(T: int, G: int, seed: int):
    H, Hkv = WIDTHS[G]
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16)
                   for s in ((T, H, HD), (T, Hkv, HD), (T, Hkv, HD), (T, H, HD)))
    with torch.no_grad():
        o, lse2 = A.full_block_attention_plain(q.float(), k.float(), v.float())
    return q, k, v, o.to(torch.bfloat16), lse2, do


@pytest.mark.parametrize("G", sorted(WIDTHS))
@pytest.mark.parametrize("T", [63, 200, 640])
def test_full_block_tiled_model_matches_the_plain_algebra(T, G):
    """The full-block mode's tiled model against
    `train_attention_bwd_plain(..., causal=False)` (O and lse from the
    all-true mask's forward), within the card's tolerance: one key block
    (T = 63: a cluster whose rank 1 sees keys past T only), two (200) and
    five (640: an odd count)."""
    q, k, v, o, lse2, do = _full_block_inputs(T, G, T * 10 + G + 1)
    got = bwd_by_schedule(q, k, v, o, lse2, do, full=True)
    want = A.train_attention_bwd_plain(q, k, v, o, lse2, do, causal=False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL * float(b.abs().max()), rtol=TOL)


@pytest.mark.parametrize("G", sorted(WIDTHS))
def test_full_block_tiled_model_is_bitwise_repeatable(G):
    """Two runs of the full-block model give the same bits (the fold order
    is fixed by the counts, not by timing)."""
    q, k, v, o, lse2, do = _full_block_inputs(200, G, G)
    first = bwd_by_schedule(q, k, v, o, lse2, do, full=True)
    again = bwd_by_schedule(q, k, v, o, lse2, do, full=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


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
