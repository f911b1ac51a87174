"""K5's tiled path on the host (ops/quant.py): the schedule `gemm_plan` (tile
width, whole tiles in full waves, stream-K shares of the rest, partial
slots and fixups) covers every output tile and every K block exactly once
at the 7B path's shapes and at ragged ones, and its int32 emulation equals
the plain product bitwise; QLinear's rows padded to 16 bytes (vision
down_proj has K = 3420) change no result and no interface: `q` stays [N,
K], and the port's quantize_model, random_quantized_model and the bridge
still agree with the JAX package's quantized tree.

The CUDA kernel that runs the plan is compared with the plain version on
the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.ops import quant as jq
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
from streaming_vlm_tpu_torch.ops import quant as Q

BM, BK = Q.GEMM_BM, Q.GEMM_BK
# (M, K, N) of every tiled product of the 7B path (chip_smoke.py K5_SERVING
# with M > 4, and K5_INT32's), then ragged shapes
SERVING = [(640, 3584, 3584), (640, 3584, 512), (640, 3584, 18944), (640, 18944, 3584),
           (2040, 1280, 3840), (2040, 1280, 1280), (2040, 1280, 3420), (2040, 3420, 1280),
           (510, 5120, 5120), (510, 5120, 3584), (4096, 4096, 4096)]
RAGGED = [(5, 64, 33), (130, 3420, 1280), (200, 1280, 3420), (300, 1280, 520), (129, 4, 257),
          (1000, 20000, 40)]


def _coverage(plan, M, N, K):
    """How often each (m tile, n tile, K block) unit is run, and each
    tile's segments."""
    mt, nt, kb = -(-M // BM), -(-N // plan.bn), -(-K // BK)
    seen = np.zeros((mt, nt, kb), np.int32)
    for m, n, k0, k1, _, _ in plan.segs:
        assert 0 <= k0 < k1 <= kb
        seen[m, n, k0:k1] += 1
    return seen


@pytest.mark.parametrize("M,K,N", SERVING + RAGGED)
@pytest.mark.parametrize("n_sms", [132, 7])
def test_plan_covers_every_tile_and_k_block_once(M, K, N, n_sms):
    """The chosen plan (gemm_plan): see _check_plan."""
    _check_plan(Q.gemm_plan(M, N, K, n_sms), M, N, K, n_sms)


@pytest.mark.parametrize("M,K,N", [(640, 3584, 3584), (640, 3584, 512), (2040, 3420, 1280),
                                   (4096, 4096, 4096)] + RAGGED)
@pytest.mark.parametrize("bn", Q.GEMM_BNS)
@pytest.mark.parametrize("max_split", (0,) + Q.MAX_SPLITS)
def test_every_candidate_plan_covers_once(M, K, N, bn, max_split):
    """Every plan gemm_plan weighs (each tile width, whole tiles or each
    stream-K cap) on 132 SMs: see _check_plan."""
    plan = Q.stream_k_plan(M, N, K, 132, bn, max_split)
    assert plan.bn == bn
    _check_plan(plan, M, N, K, 132)


def _check_plan(plan, M, N, K, n_sms):
    """Every unit once; at most n_sms CTAs (one wave); CTA loads equal to one
    K block where tiles are split (stream-K), to one tile where not; partial
    slots exactly for split tiles, contiguous per tile, one fixup each with
    at least two shares; whole-tile segments carry no slot."""
    assert plan.bn in Q.GEMM_BNS
    assert (_coverage(plan, M, N, K) == 1).all()
    assert 1 <= plan.n_ctas <= n_sms
    kb = -(-K // BK)
    whole = (plan.segs[:, 2] == 0) & (plan.segs[:, 3] == kb)
    np.testing.assert_array_equal(plan.segs[:, 4] >= 0, ~whole)
    np.testing.assert_array_equal(plan.segs[:, 5] >= 0, ~whole)
    np.testing.assert_array_equal(plan.segs[~whole, 4], np.arange(plan.n_slots))
    assert plan.fixups[:, 1].sum() == plan.n_slots and (plan.fixups[:, 1] >= 2).all()
    for f, (slot0, count) in enumerate(plan.fixups):
        mine = plan.segs[plan.segs[:, 5] == f]
        np.testing.assert_array_equal(mine[:, 4], np.arange(slot0, slot0 + count))
        assert len({(m, n) for m, n in mine[:, :2]}) == 1
        assert mine[:, 2].min() == 0 and mine[:, 3].max() == kb
    units = []
    for a, b in zip(plan.cta_segs[:-1], plan.cta_segs[1:]):
        seg = plan.segs[a:b]
        units.append(int((seg[:, 3] - seg[:, 2]).sum()))
    # stream-K shares are equal to one K block; whole tiles dealt round-robin
    # (a plan with no split tile) to one tile
    assert max(units) - min(units) <= (1 if len(plan.fixups) else kb)


def _by_plan(xq, wq, plan):
    """K5's tiled schedule in plain int32 arithmetic (through float64, as
    int8_gemm_plain): each segment's partial sum over its K blocks, a whole
    tile stored, a split tile's partials added up at its fixup."""
    M, K = xq.shape
    N = wq.shape[0]
    bn = plan.bn
    out = torch.full((M, N), -(2**31), dtype=torch.int32)
    parts = {}
    for m, n, k0, k1, slot, fix in plan.segs.tolist():
        rows, cols = slice(m * BM, (m + 1) * BM), slice(n * bn, (n + 1) * bn)
        ks = slice(k0 * BK, k1 * BK)
        acc = Q.int8_gemm_plain(xq[rows, ks], wq[cols, ks])
        if slot < 0:
            out[rows, cols] = acc
        else:
            parts.setdefault(fix, []).append(acc)
    for fix, (slot0, count) in enumerate(plan.fixups.tolist()):
        m, n = plan.segs[plan.segs[:, 5] == fix][0, :2]
        assert len(parts[fix]) == count
        out[m * BM:(m + 1) * BM, n * bn:(n + 1) * bn] = sum(parts[fix])
    return out


@pytest.mark.parametrize("M,K,N", RAGGED[:4] + [(260, 1024, 600)])
@pytest.mark.parametrize("max_split", [0, 1, 4])
def test_plan_schedule_is_the_plain_product(M, K, N, max_split):
    """The plan's int32 emulation equals int8_gemm_plain bitwise (the sums
    are exact in any order): whole tiles, and the split tiles of stream-K
    plans on a 7-SM card."""
    g = torch.Generator().manual_seed(M + K + N)
    xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    plan = Q.stream_k_plan(M, N, K, 7, Q.GEMM_BNS[-1], max_split)
    assert torch.equal(_by_plan(xq, wq, plan), Q.int8_gemm_plain(xq, wq))


@pytest.mark.parametrize("K", [64, 36, 3420])
def test_padded_qlinear_is_the_unpadded_product(K):
    """A QLinear stores q in rows padded to 16 bytes with zeros; q is the
    [N, K] view, and qdot through it equals qdot_plain on a contiguous copy
    bitwise. Moving it (to_empty, .to, deepcopy, a state_dict round trip)
    keeps the padding zero and the values."""
    N = 24
    g = torch.Generator().manual_seed(K)
    lin = torch.nn.Linear(K, N, dtype=torch.float32)
    lin.weight.data.normal_(generator=g)
    ql = Q.QLinear.from_linear(lin)
    assert ql.q.shape == (N, K) and ql.q_rows.shape == (N, Q.padded_k(K))
    assert ql.q.stride(0) % 16 == 0 and not ql.q_rows[:, K:].any()
    x = torch.randn(5, K, generator=g)
    want = Q.qdot_plain(x, ql.q.contiguous(), ql.s, ql.bias.detach(), torch.float32)
    assert torch.equal(ql(x, torch.float32), want)
    with torch.device("meta"):
        empty = Q.QLinear(K, N)
    empty.to_empty(device="cpu")
    assert not empty.q_rows[:, K:].any()
    empty.load_state_dict(ql.state_dict())
    for m in (empty, copy.deepcopy(ql), ql.to(torch.float64)):
        assert torch.equal(m.q, ql.q) and not m.q_rows[:, K:].any()
    with pytest.raises(ValueError, match="must be"):
        ql.q = torch.zeros(N, K + 4, dtype=torch.int8)


def _cfg_ragged():
    """The tiny model with a vision MLP width that is no multiple of 16 (as
    the 7B vision tower's 3420)."""
    cfg = qwen25_vl_tiny()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, intermediate_size=108))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantized_model_round_trips_with_padded_rows():
    """With vision down_proj K = 108: the port's quantize_model of the
    bridged float model equals the bridge of the JAX package's
    quantize_model_params in every q (the [N, K] views) and s, and the
    padded rows hold zeros past K; random_quantized_model has the bridged
    random tree's shapes."""
    cfg = _cfg_ragged()
    params = jm.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jq.quantize_model_params(params)
    got = Q.quantize_model(from_jax_params(cfg, _np(params), device="cpu"))
    want = from_jax_params(cfg, _np(qparams), device="cpu")
    pairs = [(a, b) for a, b in zip(got.modules(), want.modules()) if isinstance(a, Q.QLinear)]
    assert len(pairs) == 7 * cfg.text.num_hidden_layers + 1 + 5 * cfg.vision.depth + 2
    padded = 0
    for a, b in pairs:
        assert isinstance(b, Q.QLinear) and a.q.shape == b.q.shape
        assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
        for m in (a, b):
            assert not m.q_rows[:, m.in_features:].any()
        padded += a.in_features % 16 != 0
    assert padded == cfg.vision.depth  # every block's down_proj
    down = want.vision.blocks[0].down_proj
    w = np.asarray(qparams["vision"]["blocks"]["down_w"]["q"])[0]
    np.testing.assert_array_equal(down.q.numpy(), w.T)
    rand = tm.random_quantized_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    jtree = jq.random_quantized_model_params(cfg, jax.random.PRNGKey(0))
    bridged = from_jax_params(cfg, _np(jtree), device="cpu", dtype=torch.bfloat16)
    gs, ws = rand.state_dict(), bridged.state_dict()
    assert gs.keys() == ws.keys()
    for k in ws:
        assert (gs[k].dtype, gs[k].shape) == (ws[k].dtype, ws[k].shape), k
