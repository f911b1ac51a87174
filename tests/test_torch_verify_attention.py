"""K2-verify's plain version and the decoder's verify mode (a speculative-
decoding round's T tokens over the pre-rotated arena, the decode delta and
their own causal self rows) against the JAX package on the CPU: the plain
attention against `_gqa_attention_multi` over the same three parts, and
`language_forward_lanes` in verify mode against `language_forward_streaming`
with the delta as `extra`, on bridged weights (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import language as jl
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import language as tl
from streaming_vlm_tpu_torch.ops import attention as ta
from streaming_vlm_tpu_torch.ops.quant import QuantKV

CFG = qwen25_vl_tiny()
TCFG = CFG.text
ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(4), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("H,Hkv,vis,e_delta,extra_visible", [(28, 4, 37, 6, 4), (4, 2, 0, 9, 9)],
                         ids=["G7", "G2-visible0"])
def test_verify_attention_plain_matches_jax(T, H, Hkv, vis, e_delta, extra_visible):
    """The arena slots < vis, the delta rows < extra_visible and the self
    rows <= t, in one joint softmax, as the JAX verify forward builds its
    three parts (G = 7 among them)."""
    rng = np.random.default_rng(T * 100 + H + vis)
    hd, C = 16, 64
    q = rng.normal(size=(T, H, hd)).astype(np.float32)
    ka, va = (rng.normal(size=(2, C, Hkv, hd)).astype(np.float32))
    ks, vs = (rng.normal(size=(2, e_delta + T, Hkv, hd)).astype(np.float32))
    parts = [
        (ka[:vis], va[:vis], np.ones((T, vis), bool)),
        (ks[:e_delta], vs[:e_delta], np.broadcast_to(np.arange(e_delta) < extra_visible,
                                                     (T, e_delta))),
        (ks[e_delta:], vs[e_delta:], np.tril(np.ones((T, T), bool))),
    ]
    if not vis:
        parts = parts[1:]
    ref = jax.jit(jl._gqa_attention_multi)(jnp.asarray(q),
                                           [tuple(map(jnp.asarray, p)) for p in parts])
    got = ta.verify_attention_plain(
        *map(torch.from_numpy, (q, ka, va, ks, vs)), vis, extra_visible, e_delta=e_delta)
    _close(got.reshape(T, H * hd), ref)
    # the wrapper on CPU tensors is the plain version (T == 1: K2's plain version)
    wrapped = ta.streaming_verify_attention(
        *map(torch.from_numpy, (q, ka, va, ks, vs)), vis, extra_visible, e_delta=e_delta)
    _close(wrapped, got)


def _rotated_arena(rng, C):
    return (rng.normal(size=(2, TCFG.num_hidden_layers, C, TCFG.num_key_value_heads,
                             TCFG.head_dim)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8_v"])
@pytest.mark.parametrize("T,extra_visible", [(8, 0), (8, 5), (4, 11)])
def test_language_verify_mode_matches_jax(both, quant, T, extra_visible):
    """language_forward_lanes with T > 1 tokens and the decode delta (the
    spec verify forward) vs the JAX streaming forward with extra=(dkr, dv),
    extra_rotated=True: the pre-rotated float K copy, and V float or int8
    (the kv_quant="int8" engine's layout), hidden states and the block's
    K/V."""
    params, model = both
    rng = np.random.default_rng(T + extra_visible + 10 * quant)
    C, E, vis = 64, 12, 41
    emb = (rng.normal(size=(T, TCFG.hidden_size)) * 0.1).astype(np.float32)
    qpos = np.broadcast_to(np.arange(T, dtype=np.float32) + 60.0, (3, T)).copy()
    ka, va = _rotated_arena(rng, C)
    ek, ev = _rotated_arena(rng, E)
    jv, tv = jnp.asarray(va), torch.from_numpy(va)
    if quant:
        jv = jax_quantize_kv(jnp.asarray(va))
        tv = QuantKV(torch.from_numpy(np.array(jv["q"])), torch.from_numpy(np.array(jv["s"])))
    h_ref, blocks_ref = jl.language_forward_streaming(
        TCFG, params["text"], jnp.asarray(emb), jnp.asarray(qpos),
        arena=(jnp.asarray(ka), jv), arena_rotated=True, visible_len=jnp.asarray(vis, jnp.int32),
        extra=(jnp.asarray(ek), jnp.asarray(ev)), extra_rotated=True,
        extra_visible=jnp.asarray(extra_visible, jnp.int32),
    )
    h, blocks = tl.language_forward_lanes(
        TCFG, model.text, torch.from_numpy(emb)[None], torch.from_numpy(qpos)[None],
        arena=(torch.from_numpy(ka)[None], QuantKV(tv.q[None], tv.s[None]) if quant else tv[None]),
        arena_rotated=True, visible_len=[vis],
        extra=(torch.from_numpy(ek)[None], torch.from_numpy(ev)[None]),
        extra_visible=extra_visible,
    )
    _close(h[0], h_ref)
    for b, br in zip(blocks, blocks_ref):
        _close(b[0], br)


def test_verify_mode_refuses_raw_and_requantized_arenas(both):
    """T > 1 over a raw arena, or over a rotated copy requantized to int8
    (rot_quant="int8"), raises ValueError."""
    _, model = both
    rng = np.random.default_rng(0)
    T, C, E = 3, 16, 4
    emb = torch.from_numpy((rng.normal(size=(1, T, TCFG.hidden_size)) * 0.1).astype(np.float32))
    qpos = torch.zeros(1, 3, T)
    ka, va = map(torch.from_numpy, _rotated_arena(rng, C))
    ek, ev = map(torch.from_numpy, _rotated_arena(rng, E))
    kw = dict(visible_len=[5], extra=(ek[None], ev[None]), extra_visible=1)
    with pytest.raises(ValueError, match="pre-rotated"):
        tl.language_forward_lanes(TCFG, model.text, emb, qpos, arena=(ka[None], va[None]),
                                  arena_positions=torch.zeros(1, 3, C), **kw)
    kq = QuantKV(torch.zeros(1, *ka.shape, dtype=torch.int8), torch.ones(1, *ka.shape[:-1]))
    with pytest.raises(ValueError, match="rot_quant"):
        tl.language_forward_lanes(TCFG, model.text, emb, qpos, arena=(kq, va[None]),
                                  arena_rotated=True, **kw)
