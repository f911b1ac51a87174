"""K1's host-side plan (ops/attention.py `prefill_plan`): which CTA runs
which (kv head, row tile, key tile) units, the partials of row tiles split
across CTAs and their log2-space merge. The plan covers every visible (kv
head, packed row, key) pair exactly once at the 7B geometry (G = 7, Hkv =
4), and its plain PyTorch form `prefill_attention_by_plan` equals the plain
version and the JAX package's Pallas kernel in interpret mode.

The CUDA kernel that runs the plan is compared with the plain version on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.ops.attention import streaming_prefill_attention as jax_prefill
from streaming_vlm_tpu_torch.ops import attention as A

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
