"""K2's host-side split (ops/attention.py `decode_split_size`,
`decode_splits`) and its plain schedule `decode_attention_by_splits`: one
log2-space partial per split of the visible arena, one for the small block
(delta rows below extra_visible, self rows), merged under one softmax. The
splits tile [0, visible_len) exactly once and fill the card; the schedule
equals the plain version and the JAX package's Pallas kernel in interpret
mode.

The CUDA kernel that runs the schedule is compared with the plain version
on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.ops.attention import streaming_decode_attention_full as jax_decode_full
from streaming_vlm_tpu_torch.ops import attention as A

# f32 on the CPU, as tests/test_torch_attention.py
ATOL, RTOL = 2e-5, 1e-4
HKV, HD, C = 2, 64, 256
MAX_SPLIT = 160  # csrc/decode_attention.cu TILE


@pytest.mark.parametrize("visible", [0, 1, 63, 640, 9000, 10240])
@pytest.mark.parametrize("Hkv,n_sms", [(4, 132), (2, 132), (4, 16)])
def test_splits_tile_the_visible_slots_once(visible, Hkv, n_sms):
    """Every visible slot in exactly one split, nothing past visible_len; the
    split is a multiple of 8 and at most the kernel's tile; where the tile
    allows, the splits of all kv heads plus the small-block CTAs fit in one
    wave of two CTAs per SM."""
    split = A.decode_split_size(visible, Hkv, n_sms, MAX_SPLIT)
    assert split % A.DECODE_SPLIT_ALIGN == 0 and A.DECODE_SPLIT_ALIGN <= split <= MAX_SPLIT
    ranges = A.decode_splits(visible, split)
    seen = np.zeros(visible, np.int32)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= visible and hi - lo <= split
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert len(ranges) == -(-visible // split)
    if split < MAX_SPLIT:
        assert Hkv * (len(ranges) + 1) <= A.DECODE_CTAS_PER_SM * n_sms


@pytest.mark.parametrize("visible", [500, 640, 4500, 9000, 10240])
def test_splits_fill_the_card_at_7b(visible):
    """At the 7B geometry (Hkv = 4, 132 SMs) every visible length from ~500
    to 10240 gives at least 132 CTAs (arena splits plus the small block)."""
    split = A.decode_split_size(visible, 4, 132, MAX_SPLIT)
    assert 4 * (len(A.decode_splits(visible, split)) + 1) >= 132


def _inputs(seed, G, E):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(HKV * G, HD), f(C, HKV, HD), f(C, HKV, HD), f(E + 1, HKV, HD), f(E + 1, HKV, HD)


@pytest.mark.parametrize("G", [4, 7])
@pytest.mark.parametrize("visible", [0, 1, 100, C])
@pytest.mark.parametrize("extra_visible", [0, 3, 5])
@pytest.mark.parametrize("split", [8, 24, 160])
def test_schedule_matches_plain_and_pallas(G, visible, extra_visible, split):
    """decode_attention_by_splits (per-split partials, the small-block
    partial, one merge) == decode_attention_plain == the Pallas kernel in
    interpret mode, f32, at visible lengths on and off the split."""
    E = 5
    q, ka, va, ksm, vsm = _inputs(visible + split, G, E)
    t = [torch.from_numpy(x) for x in (q, ka, va, ksm, vsm)]
    got = A.decode_attention_by_splits(*t, visible, extra_visible, e_delta=E, split=split)
    plain = A.decode_attention_plain(*t, visible, extra_visible, e_delta=E)
    ref = jax_decode_full(
        *(jnp.asarray(x) for x in (q, ka, va, ksm, vsm)),
        jnp.asarray(visible, jnp.int32), jnp.asarray(extra_visible, jnp.int32),
        e_delta=E, c_b=128, interpret=True,
    )
    assert got.shape == (HKV * G, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_schedule_with_a_small_block_longer_than_a_split():
    """The small block is one part however many rows it has (the kernel
    stages it in tiles of 160 rows): 200 rows, 60 of 199 delta rows
    visible."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, ka, va, ksm, vsm = f(14, HD), f(C, HKV, HD), f(C, HKV, HD), f(200, HKV, HD), f(200, HKV, HD)
    got = A.decode_attention_by_splits(q, ka, va, ksm, vsm, 100, 60, e_delta=199, split=16)
    want = A.decode_attention_plain(q, ka, va, ksm, vsm, 100, 60, e_delta=199)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
