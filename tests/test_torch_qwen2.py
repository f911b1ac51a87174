"""The Qwen2-VL family in the port against the JAX package on qwen2_vl_tiny
(CPU, f32, the same weights through the bridge): the vision geometry
without windows (bitwise), the LayerNorm / quick_gelu tower, frames
patchified on the device (bitwise against the jitted JAX function), the
uint8-frames encode, and the streaming engine across evictions (greedy
tokens, surviving ids, cached / uncached_tail and positions) over float
and int8 arenas, with float and W8A8 weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from test_torch_engine import _engine_parity, _parity_stream
from streaming_vlm_tpu.config import qwen2_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.models.qwen25_vl import vision as jv
from streaming_vlm_tpu.ops import quant as jq
from streaming_vlm_tpu_torch.config import qwen2_vl_tiny as port_qwen2_tiny
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
from streaming_vlm_tpu_torch.models.qwen25_vl import vision as tv
from streaming_vlm_tpu_torch.ops.quant import QLinear

CFG = qwen2_vl_tiny()
V = CFG.vision
PATCH_DIM = V.in_channels * V.temporal_patch_size * V.patch_size**2
# one temporal slice, two slices, a non-square grid
GRIDS = [(1, 4, 4), (2, 4, 6), (1, 6, 10)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(params):
    """init_params leaves norms at 1 and biases at 0; move them so that the
    LayerNorm biases and the MLP biases are exercised."""
    vb = dict(params["vision"]["blocks"])
    for i, k in enumerate(("norm1", "norm2", "norm1_b", "norm2_b", "fc1_b", "fc2_b", "qkv_b",
                           "proj_b")):
        vb[k] = vb[k] + 0.1 * jax.random.normal(jax.random.PRNGKey(20 + i), vb[k].shape)
    mp = dict(params["vision"]["merger"])
    mp["ln_q_b"] = mp["ln_q_b"] + 0.1 * jax.random.normal(jax.random.PRNGKey(30), mp["ln_q_b"].shape)
    return {"text": params["text"], "vision": {**params["vision"], "blocks": vb, "merger": mp}}


@pytest.fixture(scope="module")
def both():
    params = _jitter(jm.init_params(CFG, jax.random.PRNGKey(5), dtype=jnp.float32))
    return params, from_jax_params(CFG, _np(params), device="cpu")


def test_config_is_the_qwen2_variant():
    c = port_qwen2_tiny()
    assert dataclasses.asdict(c) == dataclasses.asdict(CFG) and not c.vision.use_windows


@pytest.mark.parametrize("grid", GRIDS)
def test_vision_geometry_bitwise(grid):
    ref = jv.vision_geometry((grid,), V.window_size, V.spatial_merge_size, V.patch_size, False)
    got = tv.vision_geometry((grid,), V.window_size, V.spatial_merge_size, V.patch_size, False)
    assert set(got) == set(ref) and got["uniform_window"] == 0
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("grid", GRIDS)
def test_tower_matches_jax(both, grid):
    params, model = both
    rng = np.random.default_rng(sum(grid))
    px = rng.normal(size=(int(np.prod(grid)), PATCH_DIM)).astype(np.float32)
    ref = jm.encode_video(CFG, params, jnp.asarray(px), (grid,))
    out = tm.encode_video(CFG, model, torch.from_numpy(px), [grid])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_tower_layout(both):
    """LayerNorm with bias everywhere, fc1/fc2 in place of the SwiGLU."""
    _, model = both
    blk = model.vision.blocks[0]
    assert isinstance(blk.norm1, tv.LayerNorm) and isinstance(model.vision.ln_q, tv.LayerNorm)
    assert hasattr(blk, "fc1") and not hasattr(blk, "gate_proj")
    assert blk.fc1.out_features == V.intermediate_size


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_patchify_on_device_bitwise(out_dtype):
    """Against the JAX function jitted, as the JAX package runs it (inside
    the jitted frames encode): bitwise in f32 and bf16, over every uint8
    value of every channel."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 56, 84, 3), dtype=np.uint8)
    # every value in every channel: rows of 0..255 and their shifts
    for c in range(3):
        frames[c, 0, :, c] = np.arange(84)
        frames[c, 1, :, c] = np.arange(84, 168)
        frames[c, 2, :, c] = np.arange(168, 252)
        frames[c, 3, :4, c] = np.arange(252, 256)
    jdt = getattr(jnp, out_dtype)
    ref = np.asarray(jax.jit(lambda f: jv.patchify_on_device(V, f, out_dtype=jdt))(frames)
                     .astype(jnp.float32))
    got = tv.patchify_on_device(V, torch.from_numpy(frames), out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("grid", [(2, 4, 6), (1, 6, 10)])
def test_encode_video_frames_matches_jax(both, grid):
    params, model = both
    rng = np.random.default_rng(grid[2])
    frames = rng.integers(0, 256, (grid[0] * 2, grid[1] * 14, grid[2] * 14, 3), dtype=np.uint8)
    ref = jm.encode_video_frames(CFG, params, frames, grid, dtype=jnp.float32)
    out = tm.encode_video_frames(CFG, model, frames, grid, dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    # a tensor already on the device takes the same path
    out2 = tm.encode_video_frames(CFG, model, torch.from_numpy(frames), grid, dtype=torch.float32)
    assert torch.equal(out, out2)


@pytest.mark.parametrize("pos_mode", ["shrink", "append"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_matches_jax_across_evictions(both, kv_quant, pos_mode):
    stream = _parity_stream(pos_mode=pos_mode, kv_quant=kv_quant)
    assert _engine_parity(both, stream, cfg=CFG) >= 2


@pytest.fixture(scope="module")
def both_w8a8():
    """(JAX W8A8 tree, the port's model bridged from it). int8 activation
    rounding is discontinuous and the two frameworks' f32 sums differ by an
    ulp (test_torch_w8a8.py's both_w8a8 has the measurement), so the seed is
    pinned: PRNGKey(0) agrees in every case below."""
    params = jm.init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jq.quantize_model_params(params)
    return qparams, from_jax_params(CFG, _np(qparams), device="cpu")


@pytest.mark.parametrize("pos_mode", ["shrink", "append"])
def test_engine_w8a8_matches_jax(both_w8a8, pos_mode):
    """W8A8 (every decoder projection, the lm_head and the vision tower's
    qkv / proj / fc1 / fc2 and merger through qdot) over the int8 arena."""
    _, model = both_w8a8
    blk = model.vision.blocks[0]
    assert all(isinstance(getattr(blk, n), QLinear) for n in ("qkv", "proj", "fc1", "fc2"))
    stream = _parity_stream(pos_mode=pos_mode, kv_quant="int8")
    assert _engine_parity(both_w8a8, stream, cfg=CFG) >= 2


def test_random_quantized_model_builds_the_qwen2_tower():
    m = tm.random_quantized_model(port_qwen2_tiny(), torch.Generator().manual_seed(0),
                                  device="cpu")
    blk = m.vision.blocks[0]
    assert isinstance(blk.fc1, QLinear) and isinstance(m.vision.merger_fc1, QLinear)
    assert torch.equal(blk.norm1.bias, torch.zeros_like(blk.norm1.bias))
    out = tm.encode_video(m.cfg, m, torch.zeros(16, PATCH_DIM, dtype=torch.bfloat16), [(1, 4, 4)])
    assert out.shape == (4, m.cfg.text.hidden_size) and bool(torch.isfinite(out).all())
