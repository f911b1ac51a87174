"""K3's host-side schedule: the split that `decode_split_size` picks for the
raw-arena decode kernel (csrc/decode_attention_raw.cu, tile of 160 rows)
and K3's split-and-merge order in plain PyTorch,
`decode_attention_int8_by_splits` (each slot dequantized and rotated as the
plain version does, one log2-space partial per split and one for the small
block, one merge). The splits tile [0, visible_len) exactly once and fill
one wave of the card at the 7B geometry; the schedule equals the plain
version and the JAX package's Pallas kernel in interpret mode, for the int8
and the bf16 raw arena and shrink- and append-range positions.

The CUDA kernel that runs the schedule is compared with the plain version
on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.ops.attention import streaming_decode_attention_int8 as jax_decode_int8
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.ops import attention as A

# f32 on the CPU, as tests/test_torch_attention.py
ATOL, RTOL = 2e-5, 1e-4
HKV, HD, C = 2, 64, 256
SEC, THETA = (8, 12, 12), 1e6  # mRoPE sections of head_dim 64, the 7B rope_theta
RAW_MAX_SPLIT = 160  # csrc/decode_attention_raw.cu TILE
N_SMS, HKV_7B = 132, 4  # an H100's SMs; Qwen2.5-VL-7B's kv heads


@pytest.mark.parametrize("visible", [0, 1, 100, 500, 641, 4501, 9000, 10240])
def test_raw_splits_tile_the_visible_slots_and_fill_one_wave(visible):
    """At the 7B geometry on 132 SMs: every visible slot in exactly one
    split, nothing past visible_len, splits a multiple of 8 and at most
    K3's tile, and the grid (splits + the small block, per kv head) within
    one wave of two CTAs per SM; from ~500 visible slots on, at least one
    CTA per SM."""
    split = A.decode_split_size(visible, HKV_7B, N_SMS, RAW_MAX_SPLIT)
    assert split % A.DECODE_SPLIT_ALIGN == 0 and split <= RAW_MAX_SPLIT
    ranges = A.decode_splits(visible, split)
    seen = np.zeros(visible, np.int32)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= visible and hi - lo <= split
        seen[lo:hi] += 1
    assert (seen == 1).all()
    ctas = HKV_7B * (len(ranges) + 1)
    assert ctas <= A.DECODE_CTAS_PER_SM * N_SMS
    if visible >= 500:
        assert ctas >= N_SMS


def _inputs(seed, G, E, pos_scale, quantized):
    """Torch and JAX forms of one raw arena (int8 + scales from the JAX
    quantizer, or float), mRoPE-shaped positions with t up to pos_scale."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, ka, va, ksm, vsm = f(HKV * G, HD), f(C, HKV, HD), f(C, HKV, HD), f(E + 1, HKV, HD), f(
        E + 1, HKV, HD)
    pos = np.stack([rng.integers(0, pos_scale, C), rng.integers(0, 50, C),
                    rng.integers(0, 50, C)], axis=1).astype(np.float32)
    if quantized:
        jk, jv = jax_quantize_kv(jnp.asarray(ka)), jax_quantize_kv(jnp.asarray(va))
        jarena = (jk["q"], jk["s"], jv["q"], jv["s"])
    else:
        jarena = (jnp.asarray(ka), None, jnp.asarray(va), None)
    tarena = tuple(None if a is None else torch.from_numpy(np.array(a)) for a in jarena)
    rest = (pos, ksm, vsm)
    return ((torch.from_numpy(q), *tarena, *(torch.from_numpy(x) for x in rest)),
            (jnp.asarray(q), *jarena, *(jnp.asarray(x) for x in rest)))


@pytest.mark.parametrize("form", ["int8", "bf16"])
@pytest.mark.parametrize("pos_scale", [5000, 100_000])  # shrink-range, append-range
@pytest.mark.parametrize("visible", [0, 1, 100, C])
@pytest.mark.parametrize("split", [8, 160])
def test_raw_schedule_matches_plain_and_pallas(form, pos_scale, visible, split):
    """decode_attention_int8_by_splits == decode_attention_int8_plain == the
    Pallas kernel in interpret mode, f32, G = 7, at visible lengths on and
    off the split. ("bf16" is the unquantized raw arena, held in f32 here.)"""
    E, e_vis = 5, 3
    t, j = _inputs(visible + split, 7, E, pos_scale, form == "int8")
    kw = dict(e_delta=E, mrope_section=SEC, rope_theta=THETA)
    got = A.decode_attention_int8_by_splits(*t, visible, e_vis, split=split, **kw)
    plain = A.decode_attention_int8_plain(*t, visible, e_vis, **kw)
    ref = jax_decode_int8(*j, jnp.asarray(visible, jnp.int32), jnp.asarray(e_vis, jnp.int32),
                          c_b=128, interpret=True, **kw)
    assert got.shape == (HKV * 7, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_raw_schedule_with_a_small_block_longer_than_a_split(form):
    """The small block is one part however many rows it has (the kernel
    stages it in tiles of 160 rows): 200 rows, 60 of 199 delta rows
    visible, beside 100 arena slots in splits of 16."""
    t, _ = _inputs(3, 7, 199, 100_000, form == "int8")
    kw = dict(e_delta=199, mrope_section=SEC, rope_theta=THETA)
    got = A.decode_attention_int8_by_splits(*t, 100, 60, split=16, **kw)
    want = A.decode_attention_int8_plain(*t, 100, 60, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
