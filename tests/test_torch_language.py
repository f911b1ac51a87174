"""The port's decoder math against the JAX package on qwen25_vl_tiny, both
built from one set of weights through the weight bridge (f32, CPU)."""

import dataclasses

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
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import language as tl
from streaming_vlm_tpu_torch.models.qwen25_vl import rope as tr
from streaming_vlm_tpu_torch.ops import attention as ta
from streaming_vlm_tpu_torch.ops.quant import QuantKV, arena_capacity

CFG = qwen25_vl_tiny()
TCFG = CFG.text
ATOL, RTOL = 3e-5, 1e-4  # f32 through 4 layers (tests/test_pallas_attention.py uses 3e-5 / 1e-4)


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(3), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(CFG, np_params, device="cpu")


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


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_lm_logits_bf16_is_the_unrounded_f32_product(tied):
    """bf16 weights and hidden states: the port's lm_logits returns the f32
    product of the bf16 operands, as the JAX package's
    preferred_element_type=float32 does, within 1e-4 of max|logit|: far
    below one bf16 ulp (2^-8 relative, which a bf16-rounded product would
    show) and far above f32 summation-order noise."""
    cfg = dataclasses.replace(TCFG, tie_word_embeddings=tied)
    D, V = cfg.hidden_size, cfg.vocab_size
    rng = np.random.default_rng(9)

    def bf16(*shape):
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    (embed, jembed), (head, jhead), (hidden, jhidden) = bf16(V, D), bf16(D, V), bf16(5, D)
    lm = tl.LanguageModel(cfg, dtype=torch.bfloat16).requires_grad_(False)
    lm.embed.weight.copy_(embed)
    jparams = {"embed": jembed}
    if not tied:
        lm.lm_head.weight.copy_(head.T)
        jparams["lm_head"] = jhead
    ref = np.asarray(jl.lm_logits(cfg, jparams, jhidden))
    got = tl.lm_logits(cfg, lm, hidden)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


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


def _arenas(rng, C, quant):
    """(JAX arena pair, port arena pair): float, or int8 with the JAX
    package's quantization handed bitwise to the port's QuantKV."""
    ka, va = _arena(rng, C)
    if not quant:
        return (jnp.asarray(ka), jnp.asarray(va)), (torch.from_numpy(ka), torch.from_numpy(va))
    jk, jv = jax_quantize_kv(jnp.asarray(ka)), jax_quantize_kv(jnp.asarray(va))
    t = lambda d: QuantKV(torch.from_numpy(np.array(d["q"])), torch.from_numpy(np.array(d["s"])))  # noqa: E731
    return (jk, jv), (t(jk), t(jv))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("rotated", [True, False])
def test_streaming_prefill_mode_int8_arena(both, rotated, quant):
    """Prefill over an int8 (or float) arena: the JAX jnp path dequantizes
    each layer, the port dequantizes each layer before K1 (raw mode rotates
    in the kernel from the arena positions)."""
    params, model = both
    rng = np.random.default_rng(6)
    T, C, vis = 16, 64, 37
    emb = (rng.normal(size=(T, TCFG.hidden_size)) * 0.1).astype(np.float32)
    qpos = _positions(T, 40.0)
    apos = _positions(C)
    jarena, tarena = _arenas(rng, C, quant)
    if rotated:
        kw, tkw = dict(arena_rotated=True), dict(arena_rotated=True)
    else:
        kw = dict(arena_positions=jnp.asarray(apos))
        tkw = dict(arena_positions=torch.from_numpy(apos))
    h_ref, blocks_ref = jl.language_forward_streaming(
        TCFG, params["text"], jnp.asarray(emb), jnp.asarray(qpos), arena=jarena,
        visible_len=jnp.asarray(vis, jnp.int32), **kw,
    )
    h, blocks = tl.language_forward_streaming(
        TCFG, model.text, torch.from_numpy(emb), torch.from_numpy(qpos), arena=tarena,
        visible_len=vis, **tkw,
    )
    _close(h, h_ref)
    for b, br in zip(blocks, blocks_ref):
        _close(b, br)


@pytest.mark.parametrize("use_decode_int8", [None, False])
@pytest.mark.parametrize("quant", [False, True])
def test_streaming_decode_raw_arena(both, quant, use_decode_int8, monkeypatch):
    """Decode over the RAW arena (int8 or float): the JAX function through
    its raw-arena decode kernel (use_decode_int8=True, interpret mode) vs
    the port through K3's wrapper (None; on the CPU it runs the plain
    version) and through K3's plain version bound in the wrapper's place
    (False: the noise-floor route of chip_smoke.py's phase 4). As
    tests/test_pallas_attention.py:279."""
    params, model = both
    if use_decode_int8 is False:
        monkeypatch.setattr(tl, "streaming_decode_attention_int8", ta.decode_attention_int8_lanes_plain)
    rng = np.random.default_rng(7)
    C, E, vis, e_vis = 512, 6, 300, 4  # C a multiple of the TPU kernel's tile
    emb = (rng.normal(size=(1, TCFG.hidden_size)) * 0.1).astype(np.float32)
    qpos = np.full((3, 1), 700.0, np.float32)
    apos = _positions(C)
    jarena, tarena = _arenas(rng, C, quant)
    ek, ev = _arena(rng, E)
    h_ref, blocks_ref = jl.language_forward_streaming(
        TCFG, params["text"], jnp.asarray(emb), jnp.asarray(qpos), arena=jarena,
        arena_positions=jnp.asarray(apos), visible_len=jnp.asarray(vis, jnp.int32),
        extra=(jnp.asarray(ek), jnp.asarray(ev)), extra_rotated=True,
        extra_visible=jnp.asarray(e_vis, jnp.int32), use_decode_int8=True,
    )
    h, blocks = tl.language_forward_streaming(
        TCFG, model.text, torch.from_numpy(emb), torch.from_numpy(qpos), arena=tarena,
        arena_positions=torch.from_numpy(apos), visible_len=vis,
        extra=(torch.from_numpy(ek), torch.from_numpy(ev)), extra_visible=e_vis,
    )
    _close(h, h_ref)
    for b, br in zip(blocks, blocks_ref):
        _close(b, br)


def test_streaming_decode_prerotated_arena_int8_v(both):
    """Decode over a pre-rotated float K copy with an int8 V arena (the
    engine's kv_quant="int8" + prerotate layout): V dequantized per layer,
    then K2's route."""
    params, model = both
    rng = np.random.default_rng(8)
    C, E, vis, e_vis = 64, 6, 50, 2
    emb = (rng.normal(size=(1, TCFG.hidden_size)) * 0.1).astype(np.float32)
    qpos = np.full((3, 1), 70.0, np.float32)
    ka, _ = _arena(rng, C)
    (_, jv), (_, tv) = _arenas(rng, C, True)
    ek, ev = _arena(rng, E)
    h_ref, blocks_ref = jl.language_forward_streaming(
        TCFG, params["text"], jnp.asarray(emb), jnp.asarray(qpos),
        arena=(jnp.asarray(ka), jv), arena_rotated=True, visible_len=jnp.asarray(vis, jnp.int32),
        extra=(jnp.asarray(ek), jnp.asarray(ev)), extra_rotated=True,
        extra_visible=jnp.asarray(e_vis, jnp.int32),
    )
    h, blocks = tl.language_forward_streaming(
        TCFG, model.text, torch.from_numpy(emb), torch.from_numpy(qpos),
        arena=(torch.from_numpy(ka), tv), arena_rotated=True, visible_len=vis,
        extra=(torch.from_numpy(ek), torch.from_numpy(ev)), extra_visible=e_vis,
    )
    _close(h, h_ref)
    for b, br in zip(blocks, blocks_ref):
        _close(b, br)


def test_init_kv_arena_int8(both):
    _, model = both
    k, v = tl.init_kv_arena(TCFG, 32, torch.float32, "cpu", quant="int8")
    assert isinstance(k, QuantKV) and k.q.dtype == torch.int8 and k.s.shape == (4, 32, 2)
    assert arena_capacity(k) == 32 and k.q.data_ptr() != v.q.data_ptr()
    ref = jl.init_kv_arena(TCFG, 32, jnp.float32, quant="int8")[0]
    np.testing.assert_array_equal(k.s.numpy(), np.asarray(ref["s"]))
    with pytest.raises(ValueError, match="kv_quant"):
        tl.init_kv_arena(TCFG, 32, torch.float32, "cpu", quant="int4")


def test_bridge_layout(both):
    """The bridge unstacks the layer axis and transposes [in, out] -> [out, in]."""
    params, model = both
    q_w = np.asarray(params["text"]["layers"]["q_w"])  # [L, D, H*hd]
    for i, layer in enumerate(model.text.layers):
        np.testing.assert_array_equal(layer.q_proj.weight.numpy(), q_w[i].T)
    np.testing.assert_array_equal(
        model.text.lm_head.weight.numpy(), np.asarray(params["text"]["lm_head"]).T
    )
