"""StreamConfig.rot_quant="int8" (the per-chunk rotated K copy stored
requantized) in the port against the JAX package on qwen25_vl_tiny (CPU,
greedy): the rotated copy itself in the serving dtype bf16 (int8 data
bitwise, scales within one f32 ulp of the JAX engine's jitted
composition), and in f32 the single-stream engine across evictions and
three lanes of the multi-stream engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from test_torch_engine import CFG, _engine_parity, _parity_stream
from test_torch_multistream import STREAMS, Pair, _stream, _ve
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.models.qwen25_vl.rope import (
    apply_rope as jax_apply_rope,
    make_inv_freq,
    mrope_cos_sin as jax_mrope_cos_sin,
)
from streaming_vlm_tpu.ops.quant import dequantize_kv as jax_dequantize_kv
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.ops.quant import QuantKV
from streaming_vlm_tpu_torch.streaming.engine import rotated_copy

TCFG = CFG.text


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(7), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@jax.jit
def _jax_rotated_copy(k_arena, slot_positions):
    """The JAX engine's rot_quant="int8" copy of one stream's int8 arena
    with bf16 compute (streaming/engine.py `_chunk_step_impl`, rot_layer
    under lax.map), as it runs there: jitted."""
    inv_freq = jnp.asarray(make_inv_freq(TCFG.head_dim, TCFG.rope_theta))
    a_cos, a_sin = jax_mrope_cos_sin(slot_positions, inv_freq, TCFG.mrope_section)

    def rot_layer(lk):
        kf = jax_dequantize_kv(lk, jnp.bfloat16)
        return jax_quantize_kv(jax_apply_rope(kf, a_cos[:, None, :], a_sin[:, None, :]))

    return jax.lax.map(rot_layer, k_arena)


def test_rotated_copy_matches_jax_bits(both):
    """Two lanes' int8 arenas rotated at their own positions, bf16 compute
    (the serving dtype; in f32 XLA's contraction of the rotation into FMAs
    moves a rotated value by an ulp, and a scale with it): int8 data
    bitwise the JAX engine's, scales within one f32 ulp."""
    _, model = both
    rng = np.random.default_rng(0)
    L, C, Hkv, hd = TCFG.num_hidden_layers, 96, TCFG.num_key_value_heads, TCFG.head_dim
    k = rng.normal(size=(2, L, C, Hkv, hd)).astype(np.float32)
    pos = np.stack([np.broadcast_to(np.arange(C, dtype=np.float32) * (b + 1), (3, C))
                    for b in range(2)]).copy()
    pos[1, 1:] += rng.integers(0, 9, (2, C)).astype(np.float32)
    jq = [jax_quantize_kv(jnp.asarray(k[b])) for b in range(2)]
    tk = QuantKV(torch.from_numpy(np.stack([np.asarray(q["q"]) for q in jq])),
                 torch.from_numpy(np.stack([np.asarray(q["s"]) for q in jq])))
    got = rotated_copy(TCFG, model.text, tk, torch.from_numpy(pos), torch.bfloat16, "int8")
    for b in range(2):
        want = _jax_rotated_copy(jq[b], jnp.asarray(pos[b]))
        np.testing.assert_array_equal(got.q[b].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_max_ulp(got.s[b].numpy(), np.asarray(want["s"]), maxulp=1)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_engine_rot_quant_matches_jax(both, kv_quant):
    """The single-stream engine with the requantized rotated copy over an
    int8 or float arena, 7 chunks across evictions: greedy tokens, ids,
    occupancy and positions equal to the JAX engine's."""
    stream = _parity_stream(kv_quant=kv_quant, prerotate_arena=True, rot_quant="int8")
    assert _engine_parity(both, stream) >= 2


def test_multistream_rot_quant_matches_jax(both):
    """Three lanes with kv_quant="int8" + rot_quant="int8" (the 7B B=8
    layout), 5 rounds across eviction, against the JAX multi-stream
    engine."""
    pair = Pair(both, 3, _stream(kv_quant="int8", rot_quant="int8"))
    ve = _ve(11, 5, 3)
    for i in range(5):
        pair.round([(i, q, s) for q, s in STREAMS], ve[i])
    assert any(e.cached_after_evict < e.cached_before_evict for e in pair.t.engines)
