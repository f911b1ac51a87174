"""The port's decoder math against the JAX package on qwen25_vl_tiny, both
built from one set of weights through the weight bridge (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import language as jl
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.models.qwen25_vl import rope as jr
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import language as tl
from streaming_vlm_tpu_torch.models.qwen25_vl import rope as tr

CFG = qwen25_vl_tiny()
TCFG = CFG.text
ATOL, RTOL = 3e-5, 1e-4  # f32 through 4 layers (tests/test_pallas_attention.py uses 3e-5 / 1e-4)


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(3), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(CFG, np_params)


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _positions(n, start=0.0):
    rng = np.random.default_rng(0)
    pos = np.cumsum(rng.integers(0, 3, size=(3, n)), axis=1).astype(np.float32) + start
    return pos


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    ref = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), ref, atol=1e-6, rtol=1e-6)


def test_apply_rope_and_mrope_cos_sin():
    rng = np.random.default_rng(1)
    pos = _positions(11, 100.0)
    inv = jr.make_inv_freq(TCFG.head_dim, TCFG.rope_theta)
    jc, js = jr.mrope_cos_sin(jnp.asarray(pos), jnp.asarray(inv), TCFG.mrope_section)
    c, s = tr.mrope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv), TCFG.mrope_section)
    _close(c, jc, atol=1e-6, rtol=1e-6)
    _close(s, js, atol=1e-6, rtol=1e-6)
    x = rng.normal(size=(11, 3, TCFG.head_dim)).astype(np.float32)
    ref = jr.apply_rope(jnp.asarray(x), jc[:, None, :], js[:, None, :])
    _close(tr.apply_rope(torch.from_numpy(x), c[:, None, :], s[:, None, :]), ref, atol=1e-6, rtol=1e-6)


def test_language_forward_and_logits(both):
    params, model = both
    rng = np.random.default_rng(2)
    T = 13
    emb = (rng.normal(size=(T, TCFG.hidden_size)) * 0.1).astype(np.float32)
    pos = _positions(T)
    ref = jl.language_forward(TCFG, params["text"], jnp.asarray(emb), jnp.asarray(pos))
    out = tl.language_forward(TCFG, model.text, torch.from_numpy(emb), torch.from_numpy(pos))
    _close(out, ref)
    _close(
        tl.lm_logits(TCFG, model.text, out),
        jl.lm_logits(TCFG, params["text"], ref),
    )
    ids = rng.integers(0, TCFG.vocab_size, size=9)
    _close(
        tl.embed_tokens(TCFG, model.text, torch.from_numpy(ids)),
        jl.embed_tokens(TCFG, params["text"], jnp.asarray(ids)),
        atol=0, rtol=0,
    )


def _arena(rng, C):
    shape = (TCFG.num_hidden_layers, C, TCFG.num_key_value_heads, TCFG.head_dim)
    return (
        (rng.normal(size=shape) * 0.1).astype(np.float32),
        (rng.normal(size=shape) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("rotated", [True, False])
def test_streaming_prefill_mode(both, rotated):
    """Prefill mode (no extra): JAX jnp path vs the port's K1 route."""
    params, model = both
    rng = np.random.default_rng(4)
    T, C, vis = 16, 64, 37
    emb = (rng.normal(size=(T, TCFG.hidden_size)) * 0.1).astype(np.float32)
    qpos = _positions(T, 40.0)
    apos = _positions(C)
    ka, va = _arena(rng, C)
    if rotated:
        inv = jr.make_inv_freq(TCFG.head_dim, TCFG.rope_theta)
        c, s = jr.mrope_cos_sin(jnp.asarray(apos), jnp.asarray(inv), TCFG.mrope_section)
        ka = np.array(jr.apply_rope(jnp.asarray(ka), c[:, None, :], s[:, None, :]))
        kw = dict(arena_rotated=True)
        tkw = dict(arena_rotated=True)
    else:
        kw = dict(arena_positions=jnp.asarray(apos))
        tkw = dict(arena_positions=torch.from_numpy(apos))
    h_ref, blocks_ref = jl.language_forward_streaming(
        TCFG, params["text"], jnp.asarray(emb), jnp.asarray(qpos),
        arena=(jnp.asarray(ka), jnp.asarray(va)), visible_len=jnp.asarray(vis, jnp.int32), **kw,
    )
    h, blocks = tl.language_forward_streaming(
        TCFG, model.text, torch.from_numpy(emb), torch.from_numpy(qpos),
        arena=(torch.from_numpy(ka), torch.from_numpy(va)), visible_len=vis, **tkw,
    )
    _close(h, h_ref)
    for b, br in zip(blocks, blocks_ref):
        _close(b, br)


@pytest.mark.parametrize("extra_visible", [0, 3, 6])
def test_streaming_decode_mode(both, extra_visible):
    """Decode mode (T=1, extra = the decode delta): JAX jnp path vs the
    port's K2 route, pre-rotated arena and delta as the engine passes them."""
    params, model = both
    rng = np.random.default_rng(5)
    C, E, vis = 64, 6, 50
    emb = (rng.normal(size=(1, TCFG.hidden_size)) * 0.1).astype(np.float32)
    qpos = np.full((3, 1), 70.0, np.float32)
    ka, va = _arena(rng, C)
    ek, ev = _arena(rng, E)
    h_ref, blocks_ref = jl.language_forward_streaming(
        TCFG, params["text"], jnp.asarray(emb), jnp.asarray(qpos),
        arena=(jnp.asarray(ka), jnp.asarray(va)), arena_rotated=True,
        visible_len=jnp.asarray(vis, jnp.int32), extra=(jnp.asarray(ek), jnp.asarray(ev)),
        extra_rotated=True, extra_visible=jnp.asarray(extra_visible, jnp.int32),
    )
    h, blocks = tl.language_forward_streaming(
        TCFG, model.text, torch.from_numpy(emb), torch.from_numpy(qpos),
        arena=(torch.from_numpy(ka), torch.from_numpy(va)), arena_rotated=True,
        visible_len=vis, extra=(torch.from_numpy(ek), torch.from_numpy(ev)),
        extra_visible=extra_visible,
    )
    _close(h, h_ref)
    for b, br in zip(blocks, blocks_ref):
        _close(b, br)


def test_bridge_layout(both):
    """The bridge unstacks the layer axis and transposes [in, out] -> [out, in]."""
    params, model = both
    q_w = np.asarray(params["text"]["layers"]["q_w"])  # [L, D, H*hd]
    for i, layer in enumerate(model.text.layers):
        np.testing.assert_array_equal(layer.q_proj.weight.numpy(), q_w[i].T)
    np.testing.assert_array_equal(
        model.text.lm_head.weight.numpy(), np.asarray(params["text"]["lm_head"]).T
    )
