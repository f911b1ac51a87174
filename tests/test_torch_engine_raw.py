"""The raw arena (K1 raw mode, decode through K3's route) and the int8 KV
arena of the port's streaming engine against the JAX engine on
qwen25_vl_tiny with greedy sampling, across evictions, both built from one
set of weights through the bridge (f32, CPU; the kernels' plain
versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from test_torch_engine import CFG, GREEDY, _engine_parity, _parity_stream
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(7), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("pos_mode", ["shrink", "append"])
@pytest.mark.parametrize(
    "kv_quant,prerotate", [("int8", False), ("int8", True), ("none", False)],
    ids=["int8-raw", "int8-prerotated", "float-raw"],
)
def test_engine_raw_and_int8_arenas_match_jax(both, kv_quant, prerotate, pos_mode):
    """The raw arena (K1 raw mode + K3's route) and the int8 arena (blocks
    quantized as they merge, dequantized per layer or in K3) against the
    JAX engine on its jnp decode route (decode_int8_kernel=False)."""
    kw = dict(pos_mode=pos_mode, kv_quant=kv_quant, prerotate_arena=prerotate)
    stream = _parity_stream(**kw)
    jax_stream = _parity_stream(**kw, decode_int8_kernel=False)
    assert _engine_parity(both, stream, jax_stream) >= 2


def test_engine_int8_raw_matches_jax_decode_kernel(both):
    """The int8 raw arena against the JAX engine through its raw-arena
    decode kernel (decode_int8_kernel=True, interpret mode; the arena is a
    multiple of its tile), as tests/test_pallas_attention.py:327."""
    kw = dict(kv_quant="int8", prerotate_arena=False)
    stream = _parity_stream(**kw)
    jax_stream = _parity_stream(**kw, decode_int8_kernel=True)
    assert _engine_parity(both, stream, jax_stream) >= 2


def test_engine_rejects_rot_quant(both):
    """rot_quant takes "none" or "int8" (tests/test_torch_rot_quant.py runs
    it); any other storage of the rotated copy is refused."""
    _, model = both
    with pytest.raises(ValueError, match="rot_quant"):
        StreamingEngine(CFG, model, _parity_stream(rot_quant="int4"), GREEDY, dtype=torch.float32)
    StreamingEngine(CFG, model, _parity_stream(rot_quant="int8"), GREEDY, dtype=torch.float32)


def test_engine_rejects_plain_decode_route(both):
    """decode_int8_kernel=False would decode the raw arena outside K3: the
    port refuses it."""
    _, model = both
    stream = _parity_stream(kv_quant="int8", prerotate_arena=False, decode_int8_kernel=False)
    with pytest.raises(ValueError, match="decode_int8_kernel"):
        StreamingEngine(CFG, model, stream, GREEDY, dtype=torch.float32)
