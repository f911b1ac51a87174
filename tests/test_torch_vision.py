"""The port's vision tower against the JAX package's on uniform and ragged
window grids (f32, CPU, same weights through the bridge)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.models.qwen25_vl import vision as jv
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
from streaming_vlm_tpu_torch.models.qwen25_vl import vision as tv

# window_size 56 -> 2x2 llm-grid windows: (1, 4, 4) is one uniform window,
# (1, 6, 10) leaves ragged edge windows (the padded-window path), and
# (2, 4, 4) has two temporal slices
BASE = qwen25_vl_tiny()
CFG = dataclasses.replace(BASE, vision=dataclasses.replace(BASE.vision, window_size=56))
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
GRIDS = [(1, 4, 4), (1, 6, 10), (2, 4, 4)]


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(11), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("grid", GRIDS)
def test_vision_geometry_bitwise(grid):
    v = CFG.vision
    ref = jv.vision_geometry((grid,), v.window_size, v.spatial_merge_size, v.patch_size, True)
    got = tv.vision_geometry((grid,), v.window_size, v.spatial_merge_size, v.patch_size)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(
        tv.vision_rope_angles(got["pos_ids"], v.head_dim, v.rope_theta),
        jv.vision_rope_angles(ref["pos_ids"], v.head_dim, v.rope_theta),
    )


@pytest.mark.parametrize("grid", GRIDS)
def test_vision_forward_matches_jax(both, grid):
    params, model = both
    geo = tv.vision_geometry((grid,), CFG.vision.window_size, 2, CFG.vision.patch_size)
    assert bool(geo["uniform_window"]) == (grid != (1, 6, 10))
    rng = np.random.default_rng(sum(grid))
    px = rng.normal(size=(int(np.prod(grid)), PATCH_DIM)).astype(np.float32)
    ref = jm.encode_video(CFG, params, jnp.asarray(px), (grid,))
    out = tm.encode_video(CFG, model, torch.from_numpy(px), [grid])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_forward_full_matches_jax(both):
    """Vision embeds scattered into a token sequence + the full-attention
    decoder (the parity oracle), same ids and patches."""
    params, model = both
    tok = CFG.tokens
    grid = (1, 4, 4)
    n_vis = 4
    ids = np.array(
        [tok.im_start, 40, 41, tok.vision_start] + [tok.video_pad] * n_vis
        + [tok.vision_end, 50, 51, 52], np.int32,
    )
    px = np.random.default_rng(0).normal(size=(16, PATCH_DIM)).astype(np.float32)
    kw = dict(video_grid_thw=np.array([grid]), second_per_grid_ts=[1.0])
    ref = jm.forward_full(CFG, params, ids, pixel_patches=jnp.asarray(px), **kw)
    out = tm.forward_full(CFG, model, ids, pixel_patches=torch.from_numpy(px), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
