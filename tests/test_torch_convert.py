"""The port's HF checkpoint loading (models/convert.py) against the JAX
package's: tiny Qwen2.5-VL and Qwen2-VL models built by transformers on the
CPU and saved with save_pretrained, in f32 and bf16, with the text config
flat or nested under `text_config` and the weights under either module
layout. The port's config must equal the JAX `config_from_hf_dir`'s, its
loaded model must equal, bit for bit, the JAX loader's tree bridged by
`from_jax_params`, and its own safetensors reader must return what
`safetensors.torch.load_file` returns."""

import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.config import qwen2_vl_tiny as jax_qwen2_tiny
from streaming_vlm_tpu.config import qwen25_vl_tiny as jax_qwen25_tiny
from streaming_vlm_tpu.models import convert as jconvert
from streaming_vlm_tpu_torch.models import convert
from streaming_vlm_tpu_torch.models.bridge import from_jax_params

TEXT_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
    "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps", "rope_theta",
    "tie_word_embeddings", "rope_scaling",
)


def _hf_model(variant: str):
    """A tiny transformers model of the variant, at the JAX package's tiny
    config (as tests/test_model_parity.py builds them)."""
    if variant == "qwen2_5":
        from transformers import Qwen2_5_VLConfig as Config
        from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
            Qwen2_5_VLForConditionalGeneration as Model,
        )

        cfg = jax_qwen25_tiny()
        v = cfg.vision
        vision = dict(
            depth=v.depth, hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_heads=v.num_heads, in_channels=v.in_channels, patch_size=v.patch_size,
            temporal_patch_size=v.temporal_patch_size, spatial_merge_size=v.spatial_merge_size,
            window_size=v.window_size, fullatt_block_indexes=list(v.fullatt_block_indexes),
            out_hidden_size=v.out_hidden_size, tokens_per_second=v.tokens_per_second,
            hidden_act="silu",
        )
    else:
        from transformers import Qwen2VLConfig as Config
        from transformers.models.qwen2_vl.modeling_qwen2_vl import (
            Qwen2VLForConditionalGeneration as Model,
        )

        cfg = jax_qwen2_tiny()
        v = cfg.vision
        vision = dict(
            depth=v.depth, embed_dim=v.hidden_size, mlp_ratio=v.intermediate_size / v.hidden_size,
            num_heads=v.num_heads, in_channels=v.in_channels, patch_size=v.patch_size,
            temporal_patch_size=v.temporal_patch_size, spatial_merge_size=v.spatial_merge_size,
            hidden_size=v.out_hidden_size,
        )
    t = cfg.text
    hf_cfg = Config(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
        num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
        num_key_value_heads=t.num_key_value_heads, rms_norm_eps=t.rms_norm_eps,
        rope_theta=t.rope_theta, tie_word_embeddings=t.tie_word_embeddings,
        vision_config=vision, rope_scaling=dict(type="mrope", mrope_section=list(t.mrope_section)),
    )
    torch.manual_seed(0)
    return Model(hf_cfg).eval()


@pytest.fixture(scope="module", params=["qwen2_5", "qwen2"])
def checkpoints(request, tmp_path_factory):
    """{(dtype, layout): directory} of one variant's tiny model, saved in f32
    and bf16. Layouts: "flat" (text fields at the top of config.json, the
    older `model.*` / `visual.*` weight keys) and "nested" (text fields under
    `text_config`, transformers >= 4.52's `model.language_model.*` /
    `model.visual.*` keys)."""
    from safetensors.torch import load_file, save_file

    m = _hf_model(request.param)
    out = {}
    for dt in ("float32", "bfloat16"):
        base = tmp_path_factory.mktemp(f"{request.param}_{dt}")
        m.to(getattr(torch, dt)).save_pretrained(str(base), safe_serialization=True)
        with open(base / "config.json") as f:
            raw = json.load(f)
        text = {**raw, **raw.get("text_config", {})}
        sd = {}
        for fn in sorted(os.listdir(base)):
            if fn.endswith(".safetensors"):
                sd.update(load_file(str(base / fn)))
        for layout in ("flat", "nested"):
            d = base / layout
            d.mkdir()
            if layout == "flat":
                cfg = {k: v for k, v in raw.items() if k != "text_config"}
                cfg.update({k: text[k] for k in TEXT_KEYS if k in text})
                keys = {k: k.replace("model.language_model.", "model.").replace(
                    "model.visual.", "visual.") for k in sd}
            else:
                cfg = {k: v for k, v in raw.items() if k not in TEXT_KEYS}
                cfg["text_config"] = {k: text[k] for k in TEXT_KEYS if k in text}
                keys = {}
                for k in sd:
                    nk = k
                    if k.startswith("visual."):
                        nk = "model." + k
                    elif k.startswith("model.") and not k.startswith(("model.language_model.",
                                                                      "model.visual.")):
                        nk = "model.language_model." + k[len("model."):]
                    keys[k] = nk
            with open(d / "config.json", "w") as f:
                json.dump(cfg, f)
            # two shards, so that the loader merges files
            names = sorted(sd)
            half = len(names) // 2
            for i, part in enumerate((names[:half], names[half:])):
                save_file({keys[k]: sd[k].contiguous() for k in part},
                          str(d / f"model-0000{i + 1}-of-00002.safetensors"))
            out[(dt, layout)] = str(d)
    return request.param, out


CASES = [(dt, layout) for dt in ("float32", "bfloat16") for layout in ("flat", "nested")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_config_equals_the_jax_package(checkpoints, case):
    variant, dirs = checkpoints
    d = dirs[case]
    got, want = convert.config_from_hf_dir(d), jconvert.config_from_hf_dir(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vision.variant == variant
    ref = jax_qwen25_tiny() if variant == "qwen2_5" else jax_qwen2_tiny()
    assert dataclasses.asdict(got.text) == dataclasses.asdict(ref.text)
    # the fields that the variant reads (qwen2 has no windows)
    fields = ["variant", "depth", "hidden_size", "intermediate_size", "num_heads",
              "out_hidden_size", "tokens_per_second", "patch_size", "spatial_merge_size"]
    if variant == "qwen2_5":
        fields += ["window_size", "fullatt_block_indexes"]
    assert [getattr(got.vision, f) for f in fields] == [getattr(ref.vision, f) for f in fields]


@pytest.mark.parametrize("target", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_loaded_model_equals_the_bridged_jax_tree(checkpoints, case, target):
    """Every parameter of load_hf_checkpoint(device="cpu") bitwise equal to
    from_jax_params(JAX load_hf_checkpoint) at the same dtype (a bf16
    checkpoint read into f32 and an f32 one rounded to bf16 included)."""
    _, dirs = checkpoints
    d = dirs[case]
    dt = getattr(torch, target)
    cfg, got = convert.load_hf_checkpoint(d, device="cpu", dtype=dt)
    jcfg, jparams = jconvert.load_hf_checkpoint(d, dtype=getattr(jnp, target))
    want = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu",
                           dtype=dt)
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    for k in gs:
        assert gs[k].dtype == ws[k].dtype == dt, k
        assert torch.equal(gs[k], ws[k]), k


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_reader_equals_safetensors(checkpoints, dt):
    """The port's reader, tensor by tensor, against safetensors' own."""
    from safetensors.torch import load_file

    _, dirs = checkpoints
    d = dirs[(dt, "nested")]
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".safetensors"):
            continue
        got = convert.read_safetensors(os.path.join(d, fn))
        want = load_file(os.path.join(d, fn))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == getattr(torch, dt), k
            assert torch.equal(got[k], want[k]), k


def test_reader_takes_every_dtype(tmp_path):
    """Integer, bool, f16, f64 and empty tensors round-trip through a file
    written by safetensors."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f64": torch.randn(3, 2, generator=g, dtype=torch.float64),
        "f16": torch.randn(5, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i64": torch.arange(-4, 5),
        "i32": torch.arange(7, dtype=torch.int32),
        "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (4, 4), generator=g, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 3),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = convert.read_safetensors(path)
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


def test_loader_defaults_to_the_card(checkpoints):
    """load_hf_checkpoint builds on the card unless asked for the CPU;
    without a card the default refuses rather than falling back."""
    _, dirs = checkpoints
    assert inspect.signature(convert.load_hf_checkpoint).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            convert.load_hf_checkpoint(dirs[("float32", "flat")])
