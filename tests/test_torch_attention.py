"""The port's attention (K1 prefill, K2 decode, K3 raw-arena decode, K4
decode partials and their merge, the plain multi-source softmax) against
the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are compared with those plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.models.qwen25_vl.language import _gqa_attention_multi as jax_gqa_multi
from streaming_vlm_tpu.models.qwen25_vl.language import (
    _decode_attention_merge as jax_decode_merge,
)
from streaming_vlm_tpu.ops.attention import (
    streaming_decode_attention as jax_decode_partials,
    streaming_decode_attention_full as jax_decode_full,
    streaming_decode_attention_int8 as jax_decode_int8,
    streaming_prefill_attention as jax_prefill,
)
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.models.qwen25_vl import rope as tr
from streaming_vlm_tpu_torch.ops import attention as A
from streaming_vlm_tpu_torch.ops.quant import QuantKV

# as tests/test_pallas_attention.py (f32 on the CPU)
ATOL, RTOL = 2e-5, 1e-4
HKV, HD, C = 2, 64, 256
SEC, THETA = (8, 12, 12), 1e6  # mRoPE sections of head_dim 64, the 7B rope_theta


def _t(x):
    return torch.from_numpy(np.array(x))


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


def _raw_arena_inputs(seed, G, E, pos_scale):
    """The inputs of tests/test_pallas_attention.py:178 (mRoPE-shaped
    positions: divergent t/h/w axes), with t positions up to `pos_scale`."""
    rng = np.random.default_rng(seed)
    H = HKV * G
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x = dict(q=f(H, HD), ka=f(C, HKV, HD), va=f(C, HKV, HD), ksm=f(E + 1, HKV, HD),
             vsm=f(E + 1, HKV, HD))
    pos = np.zeros((3, C), np.float32)
    pos[0] = rng.integers(0, pos_scale, C)
    pos[1] = rng.integers(0, 50, C)
    pos[2] = rng.integers(0, 50, C)
    x["pos_t"] = np.ascontiguousarray(pos.T)
    return x


@pytest.mark.parametrize("pos_scale", [5000, 100_000])  # shrink-range, append-range
@pytest.mark.parametrize("G", [4, 7])
@pytest.mark.parametrize("visible", [0, 100, C])
@pytest.mark.parametrize("quantized", [True, False])
def test_decode_int8_plain_matches_pallas(quantized, visible, G, pos_scale):
    """K3's plain version (dequantize, rotate, joint softmax) == the TPU
    kernel in interpret mode (dequant + mRoPE rotation in the kernel), for
    the int8 and the float raw arena."""
    E, e_vis = 5, 3
    x = _raw_arena_inputs(4, G, E, pos_scale)
    if quantized:
        jk, jv = jax_quantize_kv(jnp.asarray(x["ka"])), jax_quantize_kv(jnp.asarray(x["va"]))
        jargs = (jk["q"], jk["s"], jv["q"], jv["s"])
        targs = tuple(_t(a) for a in jargs)
    else:
        jargs = (jnp.asarray(x["ka"]), None, jnp.asarray(x["va"]), None)
        targs = (_t(x["ka"]), None, _t(x["va"]), None)
    ref = jax_decode_int8(
        jnp.asarray(x["q"]), *jargs, jnp.asarray(x["pos_t"]), jnp.asarray(x["ksm"]),
        jnp.asarray(x["vsm"]), jnp.asarray(visible, jnp.int32), jnp.asarray(e_vis, jnp.int32),
        e_delta=E, mrope_section=SEC, rope_theta=THETA, c_b=128, interpret=True,
    )
    out = A.streaming_decode_attention_int8(
        _t(x["q"]), *targs, _t(x["pos_t"]), _t(x["ksm"]), _t(x["vsm"]), visible, e_vis,
        e_delta=E, mrope_section=SEC, rope_theta=THETA,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_mrope_freq_table_is_the_masked_inverse_frequencies():
    """K3's [3, hd/2] table: each channel's inverse frequency in the row of
    its mRoPE axis, so that pos . table is the plain version's angle."""
    f = A._mrope_freq_table(HD, SEC, THETA, torch.device("cpu"))
    inv = torch.from_numpy(tr.make_inv_freq(HD, THETA))
    pos = torch.from_numpy(_raw_arena_inputs(5, 4, 1, 100_000)["pos_t"])
    ang = pos[:, 0:1] * f[0] + pos[:, 1:2] * f[1] + pos[:, 2:3] * f[2]
    torch.testing.assert_close(ang, tr.mrope_angles(pos.T, inv, SEC), atol=0, rtol=0)


@pytest.mark.parametrize("G", [4, 7])
@pytest.mark.parametrize("visible", [0, 100, C])
def test_decode_partials_plain_matches_pallas(G, visible):
    """K4's plain version == the TPU partials kernel in interpret mode (m,
    l, acc; m = -1e30, l = 0, acc = 0 when nothing is visible)."""
    x = _raw_arena_inputs(6, G, 1, 10)
    ref = jax_decode_partials(
        jnp.asarray(x["q"]), jnp.asarray(x["ka"]), jnp.asarray(x["va"]),
        jnp.asarray(visible, jnp.int32), c_b=128, interpret=True,
    )
    out = A.streaming_decode_attention(_t(x["q"]), _t(x["ka"]), _t(x["va"]), visible)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("visible", [0, 100, C])
@pytest.mark.parametrize("e_vis", [0, 3])
def test_decode_merge_matches_jax_and_k2(visible, e_vis):
    """decode_attention_merge (K4 partials + exact small parts) == the JAX
    package's _decode_attention_merge, and == K2's plain version."""
    E, G = 5, 7
    x = _raw_arena_inputs(7, G, E, 10)
    H = HKV * G
    q = x["q"][None]
    ek, ev = x["ksm"][:E], x["vsm"][:E]
    ks, vs = x["ksm"][E:], x["vsm"][E:]
    emask = (np.arange(E) < e_vis)[None]
    smask = np.ones((1, 1), bool)
    jparts = [(jnp.asarray(ek), jnp.asarray(ev), jnp.asarray(emask)),
              (jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(smask))]
    ref = jax_decode_merge(
        jnp.asarray(q), jparts, jnp.asarray(x["ka"]), jnp.asarray(x["va"]),
        jnp.asarray(visible, jnp.int32), c_b=128, interpret=True,
    )
    tparts = [(_t(ek), _t(ev), _t(emask)), (_t(ks), _t(vs), _t(smask))]
    out = A.decode_attention_merge(_t(q), tparts, _t(x["ka"]), _t(x["va"]), visible)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    k2 = A.decode_attention_plain(
        _t(x["q"]), _t(x["ka"]), _t(x["va"]), _t(x["ksm"]), _t(x["vsm"]), visible, e_vis,
        e_delta=E,
    )
    np.testing.assert_allclose(out.numpy(), k2.reshape(1, H * HD).numpy(), atol=ATOL, rtol=RTOL)


def test_decode_int8_rejects_padded_small_block_and_half_scales():
    q = torch.zeros(8, HD)
    ka = torch.zeros(C, HKV, HD)
    ks = torch.zeros(5, HKV, HD)
    pos_t = torch.zeros(C, 3)
    kw = dict(e_delta=5, mrope_section=SEC, rope_theta=THETA)
    with pytest.raises(ValueError, match="no-padding"):
        A.streaming_decode_attention_int8(q, ka, None, ka, None, pos_t, ks, ks, 0, 0, **kw)
    kq = QuantKV(ka.to(torch.int8), torch.ones(C, HKV))
    ks6 = torch.zeros(6, HKV, HD)
    with pytest.raises(ValueError, match="both K and V"):
        A.streaming_decode_attention_int8(q, kq.q, kq.s, ka, None, pos_t, ks6, ks6, 0, 0, **kw)


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
    q, ka, va = _t(x["q"][0]), _t(x["ka"]), _t(x["va"])
    ksm, vsm = _t(x["ks"][:3]), _t(x["vs"][:3])
    A.streaming_decode_attention_full(q, ka, va, ksm, vsm, 10, 1, e_delta=2)
    pos_t = torch.zeros(C, 3)
    A.streaming_decode_attention_int8(
        q, ka, None, va, None, pos_t, ksm, vsm, 10, 1, e_delta=2, mrope_section=SEC,
        rope_theta=THETA,
    )
    A.streaming_decode_attention(q, ka, va, 10)
    kv = _t(x["ks"][:4])
    A.streaming_verify_attention(_t(x["q"][:2]), ka, va, kv, kv, 10, 1, e_delta=2)
    qt, kt = _t(x["q"][:8]), _t(x["ks"][:8])
    out, lse2 = A.train_attention_plain(qt, kt, kt, return_lse=True)
    A.attention_bwd(qt, kt, kt, out.reshape(qt.shape), lse2, qt)
    assert A.launch_counts == {
        "streaming_prefill_attention": 0, "streaming_decode_attention_full": 0,
        "streaming_decode_attention_int8": 0, "streaming_decode_attention": 0,
        "streaming_verify_attention": 0, "attention_bwd": 0,
    }
