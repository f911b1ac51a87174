"""K1's host-side plan (ops/attention.py `prefill_plan`): which CTA runs
which (kv head, row tile, key tile) units, the partials of row tiles split
across CTAs and their log2-space merge. The plan covers every visible (kv
head, packed row, key) pair exactly once at the 7B geometry (G = 7, Hkv =
4), and its plain PyTorch form `prefill_attention_by_plan` equals the plain
version and the JAX package's Pallas kernel in interpret mode. In the
full-block mode (ring attention's key block wholly before the queries) the
plan has no self units, and its plain form equals
`full_block_attention_plain` and, merged with the causal own block, the JAX
package's ring attention over one earlier block.

The CUDA kernel that runs the plan is compared with the plain version on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.ops.attention import streaming_prefill_attention as jax_prefill
from streaming_vlm_tpu.parallel import ring as jring
from streaming_vlm_tpu_torch.ops import attention as A
from streaming_vlm_tpu_torch.parallel.ring import merge_blocks

BM, BN = A.PREFILL_BLOCK_ROWS, A.PREFILL_BLOCK_KEYS
# f32 on the CPU, as tests/test_torch_attention.py
ATOL, RTOL = 2e-5, 1e-4
HKV, HD, C = 2, 64, 256


def _coverage(plan, T, G, Hkv, vis):
    """How often each (kv head, packed row, key) pair is attended: arena
    [Hkv, R, vis] and self [Hkv, R, T] counts, with the kernel's masks."""
    R = T * G
    arena = np.zeros((Hkv, R, vis), np.int8)
    self_ = np.zeros((Hkv, R, T), np.int8)
    n_arena = -(-vis // BN)
    for kvh, rt, ub, ue, _ in plan.segs:
        rows = np.arange(rt * BM, min((rt + 1) * BM, R))
        for u in range(ub, ue):
            if u < n_arena:
                arena[kvh, rows, u * BN: min((u + 1) * BN, vis)] += 1
            else:
                keys = np.arange((u - n_arena) * BN, min((u - n_arena + 1) * BN, T))
                self_[kvh, rows[:, None], keys[None, :]] += keys[None, :] <= rows[:, None] // G
    return arena, self_


@pytest.mark.parametrize("T", [64, 200, 640])
@pytest.mark.parametrize("vis", [0, 1000, 1024])
@pytest.mark.parametrize("n_sms", [132, 7])
def test_plan_covers_every_pair_once(T, vis, n_sms):
    """At G = 7, Hkv = 4: every visible arena pair and every causal self pair
    once, nothing else; at most n_sms CTAs (one wave), equal shares to one
    unit; partial slots only for split row tiles, contiguous per tile, one
    merge each."""
    G, Hkv = 7, 4
    plan = A.prefill_plan(T, G, Hkv, vis, n_sms)
    arena, self_ = _coverage(plan, T, G, Hkv, vis)
    assert (arena == 1).all()
    t = np.arange(T * G) // G
    np.testing.assert_array_equal(self_, np.broadcast_to(np.arange(T)[None, :] <= t[:, None], self_.shape))

    n_arena, n_self = A.prefill_units(T, G, vis)
    total = Hkv * int((n_arena + n_self).sum())
    assert plan.n_ctas == min(n_sms, total)
    share = [int((plan.segs[a:b, 3] - plan.segs[a:b, 2]).sum())
             for a, b in zip(plan.cta_segs[:-1], plan.cta_segs[1:])]
    assert sum(share) == total and max(share) - min(share) <= 1
    split = plan.segs[:, 4] >= 0
    whole = (plan.segs[:, 2] == 0) & (plan.segs[:, 3] == (n_arena + n_self)[plan.segs[:, 1]])
    np.testing.assert_array_equal(split, ~whole)
    np.testing.assert_array_equal(plan.segs[split, 4], np.arange(plan.n_partials))
    assert plan.merges[:, 3].sum() == plan.n_partials
    for kvh, rt, p0, n in plan.merges:
        mine = (plan.segs[:, 0] == kvh) & (plan.segs[:, 1] == rt)
        np.testing.assert_array_equal(plan.segs[mine, 4], np.arange(p0, p0 + n))
        assert n >= 2


def _inputs(seed, G, T):
    rng = np.random.default_rng(seed)
    H = HKV * G
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ang = rng.normal(size=(C, HD // 2)).astype(np.float32)
    return dict(
        q=f(T, H, HD), ka=f(C, HKV, HD), va=f(C, HKV, HD), ks=f(T, HKV, HD), vs=f(T, HKV, HD),
        acos2=np.concatenate([np.cos(ang)] * 2, -1), asin2=np.concatenate([np.sin(ang)] * 2, -1),
    )


@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("visible", [0, 100, C])
@pytest.mark.parametrize("raw", [False, True])
def test_by_plan_matches_plain_and_pallas(G, visible, raw):
    """The plan's plain form, with whole row tiles per CTA (132 SMs) and with
    row tiles split across CTAs (5 and 3 SMs: partials merged in log2
    space), equals the plain version and the TPU kernel in interpret mode
    at f32 (atol 2e-5, rtol 1e-4)."""
    T = 64
    x = _inputs(1, G, T)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cs = (t["acos2"], t["asin2"]) if raw else (None, None)
    ka = t["ka"]
    if not raw:  # pre-rotated arena: rotated outside, no cos/sin
        ka = A._rotate_dup_half(ka, t["acos2"], t["asin2"])
    args = (t["q"], ka, t["va"], *cs, t["ks"], t["vs"], visible)
    ref = jax_prefill(
        *(None if a is None else jnp.asarray(a.numpy()) for a in args[:7]),
        jnp.asarray(visible, jnp.int32), t_b=64, c_b=128, interpret=True,
    )
    plain = A.prefill_attention_plain(*args)
    merged = 0
    for n_sms in (132, 5, 3):
        merged += len(A.prefill_plan(T, G, HKV, visible, n_sms).merges)
        out = A.prefill_attention_by_plan(*args, n_sms)
        assert out.shape == (T, HKV * G, HD) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    assert merged or visible == 0  # a row tile of one unit (visible 0) cannot split


@pytest.mark.parametrize("T", [64, 200, 640])
@pytest.mark.parametrize("n_sms", [132, 7])
def test_full_block_plan_covers_every_pair_once(T, n_sms):
    """The full-block mode (self_block=False) at G = 7, Hkv = 4 over a key
    block of T keys: every (kv head, packed row, key) pair of the block
    once, no self unit, at most n_sms CTAs with equal shares to one unit,
    and one merge for each row tile split across CTAs."""
    G, Hkv = 7, 4
    plan = A.prefill_plan(T, G, Hkv, T, n_sms, self_block=False)
    arena, self_ = _coverage(plan, T, G, Hkv, T)
    assert (arena == 1).all() and not self_.any()
    n_arena, n_self = A.prefill_units(T, G, T, self_block=False)
    assert not n_self.any()
    assert (plan.segs[:, 3] <= n_arena).all()
    total = Hkv * n_arena * len(n_self)
    assert plan.n_ctas == min(n_sms, total)
    share = [int((plan.segs[a:b, 3] - plan.segs[a:b, 2]).sum())
             for a, b in zip(plan.cta_segs[:-1], plan.cta_segs[1:])]
    assert sum(share) == total and max(share) - min(share) <= 1
    whole = (plan.segs[:, 2] == 0) & (plan.segs[:, 3] == n_arena)
    np.testing.assert_array_equal(plan.segs[:, 4] >= 0, ~whole)
    assert plan.merges[:, 3].sum() == plan.n_partials
    split_tiles = {(h, rt) for h, rt, *_ in plan.segs[~whole].tolist()}
    assert {(h, rt) for h, rt, *_ in plan.merges.tolist()} == split_tiles
    assert len(plan.merges) == len(split_tiles)


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX package's ring attention (`_ring_gqa_attention`, jitted)
    over a 'seq' axis of 2 blocks, vmapped: block 1's queries see block 0
    wholly, then their own block causally."""
    return jax.jit(jax.vmap(lambda q, k, v: jring._ring_gqa_attention(q, k, v, "seq"),
                            axis_name="seq"))


@pytest.mark.parametrize("T", [64, 200])
def test_full_block_by_plan_matches_plain_and_the_ring(T, jax_ring):
    """`prefill_attention_by_plan(..., self_block=False)` at G = 7 (whole
    row tiles at 132 SMs; split ones merged at 5) equals
    `full_block_attention_plain` in f32 (atol 2e-5, rtol 1e-4); merged with
    the causal own block by each one's log-sum-exp (ring attention's
    `merge_blocks`) it equals the JAX package's ring attention over one
    earlier block (its step over block 0, then its own), to the same
    tolerance."""
    G = 7
    H = HKV * G
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = f(2, T, H, HD), f(2, T, HKV, HD), f(2, T, HKV, HD)  # blocks 0 and 1
    qt, k0, v0 = (torch.from_numpy(x) for x in (q[1], k[0], v[0]))
    plain, _ = A.full_block_attention_plain(qt, k0, v0)
    merged = 0
    for n_sms in (132, 5):
        merged += len(A.prefill_plan(T, G, HKV, T, n_sms, self_block=False).merges)
        out = A.prefill_attention_by_plan(qt, k0, v0, None, None, None, None, T, n_sms,
                                          self_block=False)
        assert out.shape == (T, H, HD) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    assert merged or T <= BN  # a block of one key tile splits no row tile
    lse_block = A.prefill_lse_plain(qt, k0, None, None, None, T)
    own, lse_own = A.train_attention_plain(qt, torch.from_numpy(k[1]), torch.from_numpy(v[1]),
                                           return_lse=True)
    got, _ = merge_blocks(own.reshape(T, H, HD), lse_own, out, lse_block)
    want = np.asarray(jax_ring(q[:, None], k[:, None], v[:, None]))[1, 0]
    np.testing.assert_allclose(got.reshape(T, H * HD).numpy(), want, atol=ATOL, rtol=RTOL)
