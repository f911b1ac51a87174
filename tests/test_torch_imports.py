"""The port stands alone: no module of streaming_vlm_tpu_torch, and nothing in
chip_smoke.py, imports jax or the JAX package `streaming_vlm_tpu`, nor the
checkpoint libraries that only the JAX loader leans on (safetensors,
transformers, ml_dtypes: the port reads safetensors files itself); the
port's copies of the JAX package's configuration and host helpers stay
equal to the originals."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import streaming_vlm_tpu.config as jcfg
import streaming_vlm_tpu_torch.config as tcfg
from streaming_vlm_tpu.utils.buckets import bucket_for as jax_bucket_for
from streaming_vlm_tpu.utils.vtt import sec2ts as jax_sec2ts
from streaming_vlm_tpu.video import ingest as jax_ingest
from streaming_vlm_tpu_torch.utils.buckets import bucket_for
from streaming_vlm_tpu_torch.utils.vtt import sec2ts
from streaming_vlm_tpu_torch.video import ingest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "streaming_vlm_tpu_torch"


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="streaming_vlm_tpu_torch.")
    )


FORBIDDEN = ("jax", "jaxlib", "streaming_vlm_tpu", "safetensors", "transformers", "ml_dtypes")


def _is_forbidden(mod: str) -> bool:
    return mod.split(".")[0] in FORBIDDEN


def test_every_port_module_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert len(mods) > 15 and {
        "streaming_vlm_tpu_torch.serve", "streaming_vlm_tpu_torch.ops.quant",
        "streaming_vlm_tpu_torch.ops._kernels", "streaming_vlm_tpu_torch.models.bridge",
        "streaming_vlm_tpu_torch.streaming.multistream", "streaming_vlm_tpu_torch.models.convert",
    } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=300)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    [REPO / "chip_smoke.py"] + sorted(PORT.rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_has_no_jax_import(path):
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_config_copy_equals_the_jax_package():
    names = ["TextConfig", "VisionConfig", "SpecialTokens", "ModelConfig", "StreamConfig",
             "SamplingConfig", "VideoConfig"]
    for n in names:
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, n))]
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, n))]
        assert tf == jf, n
        assert dataclasses.asdict(getattr(tcfg, n)()) == dataclasses.asdict(getattr(jcfg, n)()), n
    for preset in ("qwen25_vl_tiny", "qwen25_vl_3b", "qwen25_vl_7b", "qwen2_vl_7b",
                   "qwen2_vl_tiny"):
        t, j = getattr(tcfg, preset)(), getattr(jcfg, preset)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), preset
    assert tcfg.PRESETS.keys() == jcfg.PRESETS.keys()
    for k in jcfg.PRESETS:
        assert dataclasses.asdict(tcfg.PRESETS[k]()) == dataclasses.asdict(jcfg.PRESETS[k]()), k
    for kw in (dict(), dict(kv_capacity=40000), dict(prerotate_arena=False), dict(window_size=8)):
        t, j = tcfg.StreamConfig(**kw), jcfg.StreamConfig(**kw)
        assert (t.effective_prerotate, t.visual_round) == (j.effective_prerotate, j.visual_round)
    v = tcfg.VideoConfig()
    assert v.max_pixels_for_window(16) == jcfg.VideoConfig().max_pixels_for_window(16)


def test_host_helpers_equal_the_jax_package():
    buckets = (64, 128, 640)
    for n in (1, 64, 65, 600, 640):
        assert bucket_for(n, buckets) == jax_bucket_for(n, buckets)
    with pytest.raises(ValueError, match="exceeds the largest bucket 640") as e:
        bucket_for(641, buckets, what="chunk", fix=" Fix it.")
    with pytest.raises(ValueError) as je:
        jax_bucket_for(641, buckets, what="chunk", fix=" Fix it.")
    assert str(e.value) == str(je.value)
    for t in (0.0, 1.0005, 59.9996, 3599.5, 3723.25, 86399.999):
        assert sec2ts(t) == jax_sec2ts(t)
    rng = np.random.default_rng(0)
    for shape in ((2, 56, 84, 3), (3, 28, 28, 3)):
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        got, grid = ingest.patchify_frames(frames)
        ref, jgrid = jax_ingest.patchify_frames(frames)
        assert grid == jgrid
        np.testing.assert_array_equal(got, ref)
    for hw in ((480, 640), (1080, 1920), (50, 3000), (20, 20)):
        assert ingest.smart_resize(*hw) == jax_ingest.smart_resize(*hw)
    ts = np.cumsum(np.full(40, 0.1))
    for s, e in ((0.0, 1.0), (1.0, 2.0), (None, None)):
        assert ingest.select_chunk_frames(ts, s, e, fps=2.0, only_last=2) == \
            jax_ingest.select_chunk_frames(ts, s, e, fps=2.0, only_last=2)


def test_native_ingest_builds_outside_the_source_tree():
    """The port's ingest library path lies under the git-ignored build/
    tree, keyed by the source's hash, never beside the C++ source."""
    p = ingest.library_path()
    assert p.parent == REPO / "build" / "torch_ingest"
    assert ingest.SOURCE.parent != p.parent and ingest.SOURCE.exists()
