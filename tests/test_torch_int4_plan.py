"""K5-int4's host plan (ops/quant.py `int4_plan`) on the CPU, with a
plain model of the kernel's schedule kept here (`int4_parts`: which warp
of which CTA runs which (tile, groups) part; `qdot4_by_plan`: those parts'
exact group sums, folded as the kernel folds them): every plan the planner
picks at the 7B decode shapes and the lm_head, and forced slabs, covers
each (16-channel tile, 128-row group) exactly once within shared memory;
the schedule (per-group f32 records folded in group order by a tile's
last part) is bitwise equal to `qdot4_plain` and to the JAX package's
jitted `qdot4` below 32 rows. The kernel itself runs only on the card
(tests/test_torch_cuda.py holds it to `qdot4_plain` under every plan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cpu import one_cpu_thread  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.ops import quant as jq
from streaming_vlm_tpu_torch.ops import quant as tq

SMS = 132  # an H100's SMs
# the 7B decode products (N, K) and the lm_head
SHAPES = {"q/o_proj": (3584, 3584), "k/v_proj": (512, 3584), "gate/up_proj": (18944, 3584),
          "down_proj": (3584, 18944), "lm_head": (152064, 3584)}


def int4_parts(plan, N, K):
    """The plan's parts as (cta, warp, tile, first group, end group), each
    warp's in the order it runs them: what csrc/int4_gemv.cu computes from
    the plan's four numbers (CTA b runs slab b % slabs, its warp w the tiles
    j + ctas * w + ctas * WARPS * i, j = b // slabs)."""
    nk, T = -(-K // tq.INT4_GROUP), -(-N // tq.INT4_TILE_N)
    parts = []
    for b in range(plan.n_ctas):
        p, j = b % plan.slabs, b // plan.slabs
        g0 = p * plan.slab_groups
        g1 = min(g0 + plan.slab_groups, nk)
        for w in range(tq.INT4_WARPS):
            for t in range(j + plan.ctas * w, T, plan.ctas * tq.INT4_WARPS):
                parts.append((b, w, t, g0, g1))
    return parts


def qdot4_by_plan(x, q4, s, bias=None, out_dtype=None, plan=None):
    """K5-int4's schedule in plain PyTorch, below 32 rows: each part of
    `int4_parts(plan)` takes its groups' exact int32 sums; with one slab
    each tile's part folds them in group order as it goes; with more, each
    part leaves f32 records (sums, scales) and the tile's last part to
    arrive (here the parts arrive in reverse) folds all of the tile's groups
    from the records in group order. One scale a row (ng = 1): the sums
    add up exactly."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M, N, ng = x2.shape[0], q4.shape[0], s.shape[1]
    plan = plan or tq.int4_plan(M, N, K, SMS)
    nk = -(-K // tq.INT4_GROUP)
    xq, sx = tq.quantize_rows(x2)
    pad = nk * tq.INT4_GROUP - K  # the last group's rows past K: zeros on both sides
    xg = F.pad(xq.double(), (0, pad)).reshape(M, nk, tq.INT4_GROUP)
    wg = F.pad(tq.unpack_int4(q4).double(), (0, pad)).reshape(N, nk, tq.INT4_GROUP)
    acc = torch.einsum("mgk,ngk->gmn", xg, wg).float()  # [nk, M, N], exact
    a = torch.zeros(M, N, dtype=torch.float32)
    records, arrived = {}, {}
    for _, _, t, g0, g1 in reversed(int4_parts(plan, N, K)):
        cols = slice(t * tq.INT4_TILE_N, min(N, (t + 1) * tq.INT4_TILE_N))
        n = cols.stop - cols.start
        if ng == 1:
            a[:, cols] = acc[g0:g1, :, cols].double().sum(0).float()
            continue
        if plan.slabs == 1:
            for g in range(g0, g1):
                a[:, cols] = tq.fma_f32(acc[g, :, cols], s[cols, g].expand(M, n), a[:, cols])
            continue
        for g in range(g0, g1):
            records[t, g] = (acc[g, :, cols], s[cols, g])
        arrived[t] = arrived.get(t, 0) + 1
        if arrived[t] == plan.slabs:  # the last part: every group, in order
            for g in range(nk):
                v, sc = records.pop((t, g))
                a[:, cols] = tq.fma_f32(v, sc.expand(M, n), a[:, cols])
    b = (sx * s[:, 0]).expand(M, N) if ng == 1 else sx.expand(M, N)
    return tq._qdot4_out(a, b, bias, out_dtype or x.dtype, lead)


# (shape, rows, forced slabs): the planner's pick (None) at every decode
# shape and row count, forced splits at the narrow and long-K products
PLANS = ([(w, M, None) for w in SHAPES for M in (1, 4, 8, 31)]
         + [(w, M, s) for w in ("q/o_proj", "k/v_proj", "down_proj") for M in (1, 8, 31)
            for s in (2, 3, 4, 37)]
         + [("lm_head", 1, 2), ("gate/up_proj", 4, 3)])


@pytest.mark.parametrize("what,M,slabs", PLANS)
def test_plan_covers_each_tile_group_once(what, M, slabs):
    N, K = SHAPES[what]
    plan = tq.int4_plan(M, N, K, SMS, slabs)
    nk, T = K // tq.INT4_GROUP, -(-N // tq.INT4_TILE_N)
    assert plan.n_ctas <= SMS and 2 <= plan.stages <= tq.INT4_STAGES
    assert tq.int4_smem_bytes(M, plan.slab_groups, plan.stages) <= tq.INT4_SMEM_CAP
    assert plan.slabs == 1 or plan.slab_groups % tq.INT4_STAGE_GROUPS == 0
    if slabs:
        assert plan.slabs >= min(slabs, nk // tq.INT4_STAGE_GROUPS)
    parts = np.array(int4_parts(plan, N, K))
    cta, warp, tile, g0, g1 = parts.T
    assert ((0 <= warp) & (warp < tq.INT4_WARPS) & (g0 < g1)).all()
    cover = np.zeros((T, nk + 1), np.int64)  # +1 at a part's first group, -1 past its last
    np.add.at(cover, (tile, g0), 1)
    np.add.at(cover, (tile, g1), -1)
    assert (np.cumsum(cover, axis=1)[:, :nk] == 1).all()
    assert len({(c, a) for c, a in zip(cta, g0)}) == len(set(cta))  # one slab a CTA


def test_planner_picks():
    """One slab where the tiles alone outnumber the card's warps (gate/up,
    the lm_head); K cut where they do not (k/v, q/o, down_proj), keeping
    every warp on at most one part; one scale group never cut; 31 rows at
    K = 18944 cut further, for their quantized rows to fit."""
    warps = SMS * tq.INT4_WARPS
    for M in (1, 4, 8):
        for what, (N, K) in SHAPES.items():
            plan, T = tq.int4_plan(M, N, K, SMS), -(-N // tq.INT4_TILE_N)
            assert (plan.slabs == 1) == (what in ("gate/up_proj", "lm_head"))
            assert plan.slabs == 1 or T * plan.slabs <= warps
    assert tq.int4_plan(1, 3584, 3592, SMS).slabs == 1
    assert tq.int4_plan(31, 3584, 18944, SMS).slabs > tq.int4_plan(1, 3584, 18944, SMS).slabs
    with pytest.raises(ValueError, match="one scale group"):
        tq.int4_plan(1, 64, 200, SMS, slabs=2)


def test_one_group_rows_that_do_not_fit_raise():
    """One scale group cannot be cut into slabs: rows whose quantized copy
    leaves no room for two ring stages a warp are refused, not run in
    turns (31 rows at K = 18952, one group of 18952 rows)."""
    assert tq.int4_groups(18952) == 1
    assert tq.int4_smem_bytes(31, -(-18952 // tq.INT4_GROUP), 2) > tq.INT4_SMEM_CAP
    with pytest.raises(ValueError, match="one scale group"):
        tq.int4_plan(31, 3584, 18952, SMS)
    assert tq.int4_plan(4, 3584, 18952, SMS).slabs == 1


@pytest.mark.parametrize("D,F", [(384, 40), (200, 24), (256, 16)], ids=["ng3", "ng1", "ng2"])
def test_qlinear4_keeps_padded_rows(D, F):
    """QLinear4 keeps q4 and s in rows 16 bytes apart (what K5-int4's tensor
    maps read in place), their padding zero through assignment, to_empty and
    a state_dict round trip; q4 and s read as the quantized weight, and the
    forward is qdot4's."""
    rng = np.random.default_rng(D + F)
    w = torch.from_numpy(rng.normal(size=(F, D)).astype(np.float32))
    q4, s = tq.quantize_weight_int4(w)
    lin = tq.QLinear4.from_weight(w)
    for got, want, row_bytes in ((lin.q4, q4, 1), (lin.s, s, 4)):
        assert torch.equal(got, want) and got.stride(1) == 1
        assert got.shape[1] == 1 or (got.stride(0) * row_bytes) % 16 == 0
    moved = tq.QLinear4(D, F, bias=False, device="meta").to_empty(device="cpu")
    assert not moved.q4_rows[:, D // 2:].any() and not moved.s_rows[:, moved.ng:].any()
    moved.load_state_dict(lin.state_dict())
    for m in (lin, moved):
        assert not m.q4_rows[:, D // 2:].any() and not m.s_rows[:, m.ng:].any()
        assert torch.equal(m.q4, q4) and torch.equal(m.s, s)
    x = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32))
    assert torch.equal(moved(x), tq.qdot4_plain(x, q4, s))
    with pytest.raises(ValueError, match="must be"):
        lin.q4 = q4[:, :-1]


def _inputs(M, N, K, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32) * 2).to(dtype)
    if M > 2:
        x[1] = 0
        x[2, 7] = 500.0
    q4 = torch.from_numpy(rng.integers(-128, 128, (N, K // 2)).astype(np.int8))
    s = torch.from_numpy(rng.random((N, tq.int4_groups(K))).astype(np.float32) * 1e-2 + 1e-4)
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    return x, q4, s, b


@pytest.mark.parametrize("M", [1, 4, 8, 31])
@pytest.mark.parametrize("K,slabs", [(256, None), (256, 2), (18944, None), (18944, 2),
                                     (18944, 3), (18944, 37), (392, None)],
                         ids=["ng2", "ng2-split", "ng148", "ng148-2", "ng148-3", "ng148-37",
                              "ng1"])
def test_by_plan_bitwise_plain(K, slabs, M):
    """Forced slabs (two, three, one a stage) and the planner's pick, at a
    small ragged N (3 tiles, the last partial), bf16 and f32 out with and
    without bias; one scale group (K = 392) is never cut."""
    N = 40
    x, q4, s, b = _inputs(M, N, K, seed=M * K)
    plan = tq.int4_plan(M, N, K, SMS, slabs)
    for od, bias in ((torch.bfloat16, b.to(torch.bfloat16)), (torch.float32, b),
                     (torch.float32, None)):
        got = qdot4_by_plan(x, q4, s, bias, od, plan)
        assert torch.equal(got, tq.qdot4_plain(x, q4, s, bias, od))


jax_qdot4 = jax.jit(jq.qdot4, static_argnames="out_dtype")


@pytest.mark.parametrize("T,K,slabs", [(1, 512, 1), (1, 512, 2), (8, 384, 1), (8, 384, 2),
                                     (31, 512, 1), (31, 512, 2), (4, 200, 1)])
def test_by_plan_matches_jax(T, K, slabs):
    """The split schedule against the JAX package's jitted qdot4 (its layout:
    q4 [K/2, N], s [ng, N]), bitwise, as test_torch_w4a8.py holds qdot4;
    K = 200 has one scale group (never cut)."""
    N = 24
    x, q4, s, _ = _inputs(T, N, K, seed=T + K)
    jw = {"q4": jnp.asarray(q4.numpy().T), "s": jnp.asarray(s.numpy().T)}
    for od in ("bfloat16", "float32"):
        ref = np.asarray(jax_qdot4(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jw,
                                   out_dtype=getattr(jnp, od)).astype(jnp.float32))
        plan = tq.int4_plan(T, N, K, SMS, slabs)
        got = qdot4_by_plan(x, q4, s, out_dtype=getattr(torch, od), plan=plan)
        np.testing.assert_array_equal(got.float().numpy(), ref)
