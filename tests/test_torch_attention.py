"""The port's attention (K1 prefill, K2 decode, the plain multi-source
softmax) against the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are compared with those plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.models.qwen25_vl.language import _gqa_attention_multi as jax_gqa_multi
from streaming_vlm_tpu.ops.attention import (
    streaming_decode_attention_full as jax_decode_full,
    streaming_prefill_attention as jax_prefill,
)
from streaming_vlm_tpu_torch.ops import attention as A

# as tests/test_pallas_attention.py (f32 on the CPU)
ATOL, RTOL = 2e-5, 1e-4
HKV, HD, C = 2, 64, 256


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(seed, G, T):
    rng = np.random.default_rng(seed)
    H = HKV * G
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ang = rng.normal(size=(C, HD // 2)).astype(np.float32)
    return dict(
        q=f(T, H, HD), ka=f(C, HKV, HD), va=f(C, HKV, HD), ks=f(T, HKV, HD), vs=f(T, HKV, HD),
        acos2=np.concatenate([np.cos(ang)] * 2, -1), asin2=np.concatenate([np.sin(ang)] * 2, -1),
    )


@pytest.mark.parametrize("G", [4, 7])
@pytest.mark.parametrize("visible", [0, 100, C])
@pytest.mark.parametrize("raw", [False, True])
def test_prefill_plain_matches_pallas(G, visible, raw):
    T = 64
    x = _inputs(0, G, T)
    if raw:
        ka, c2, s2 = x["ka"], x["acos2"], x["asin2"]
    else:  # pre-rotated arena: rotate outside, pass no cos/sin
        half = HD // 2
        rot = np.concatenate([-x["ka"][..., half:], x["ka"][..., :half]], -1)
        ka = x["ka"] * x["acos2"][:, None] + rot * x["asin2"][:, None]
        c2 = s2 = None
    ref = jax_prefill(
        jnp.asarray(x["q"]), jnp.asarray(ka), jnp.asarray(x["va"]),
        None if c2 is None else jnp.asarray(c2), None if s2 is None else jnp.asarray(s2),
        jnp.asarray(x["ks"]), jnp.asarray(x["vs"]), jnp.asarray(visible, jnp.int32),
        t_b=64, c_b=128, interpret=True,
    )
    out = A.streaming_prefill_attention(
        _t(x["q"]), _t(ka), _t(x["va"]), None if c2 is None else _t(c2),
        None if s2 is None else _t(s2), _t(x["ks"]), _t(x["vs"]), visible,
    )
    assert out.shape == (T, HKV * G, HD) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("G", [4, 7])
@pytest.mark.parametrize("visible", [0, 100, C])
@pytest.mark.parametrize("extra_visible", [0, 3, 5])
def test_decode_plain_matches_pallas(G, visible, extra_visible):
    E = 5
    rng = np.random.default_rng(1)
    H = HKV * G
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, ka, va = f(H, HD), f(C, HKV, HD), f(C, HKV, HD)
    ksm, vsm = f(E + 1, HKV, HD), f(E + 1, HKV, HD)
    ref = jax_decode_full(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va), jnp.asarray(ksm), jnp.asarray(vsm),
        jnp.asarray(visible, jnp.int32), jnp.asarray(extra_visible, jnp.int32),
        e_delta=E, c_b=128, interpret=True,
    )
    out = A.streaming_decode_attention_full(
        _t(q), _t(ka), _t(va), _t(ksm), _t(vsm), visible, extra_visible, e_delta=E
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_decode_rejects_padded_small_block():
    q = torch.zeros(8, HD)
    ka = torch.zeros(C, HKV, HD)
    ks = torch.zeros(5, HKV, HD)
    with pytest.raises(ValueError, match="no-padding"):
        A.streaming_decode_attention_full(q, ka, ka, ks, ks, 0, 0, e_delta=5)


@pytest.mark.parametrize("G", [1, 7])
def test_gqa_attention_multi_matches_jax(G):
    rng = np.random.default_rng(2)
    T, S1, S2 = 5, 9, 4
    H = HKV * G
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q = f(T, H, HD)
    parts = [
        (f(S1, HKV, HD), f(S1, HKV, HD), rng.random((T, S1)) < 0.7),
        (f(S2, HKV, HD), f(S2, HKV, HD), np.tril(np.ones((T, S2), bool))),
    ]
    ref = jax_gqa_multi(jnp.asarray(q), [tuple(jnp.asarray(a) for a in p) for p in parts])
    out = A.gqa_attention_multi(_t(q), [tuple(_t(a) for a in p) for p in parts])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_cpu_wrappers_do_not_count_launches():
    A.reset_launch_counts()
    x = _inputs(3, 7, 64)
    A.streaming_prefill_attention(
        *(_t(x[k]) for k in ("q", "ka", "va")), None, None, _t(x["ks"]), _t(x["vs"]), 10
    )
    assert A.launch_counts == {
        "streaming_prefill_attention": 0, "streaming_decode_attention_full": 0
    }
