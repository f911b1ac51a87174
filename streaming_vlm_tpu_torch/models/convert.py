"""HF Qwen2-VL / Qwen2.5-VL checkpoint directory -> the port's model.

Port of the numpy half of streaming_vlm_tpu/models/convert.py:
`config_from_hf_dir` (config.json, flat or with the text fields nested
under `text_config`, both `model_type`s), the key normalisation of both HF
module layouts (transformers >= 4.52: `model.language_model.*`,
`model.visual.*`; older: `model.*`, `visual.*`), and a
`model_from_state_dict` that fills the port's `Qwen25VL` straight from the
HF state dict. The safetensors shards are read by this module's own
reader (`load_safetensors_state_dict`): the 8-byte little-endian header
length, the JSON header, then one `torch.frombuffer` view per tensor over
a copy-on-write memory map (bf16 read as 16-bit words and viewed as
torch.bfloat16), so that neither `safetensors` nor `ml_dtypes` is needed.
The JAX package's serving-checkpoint half (a pre-quantized msgpack blob
through flax) is JAX-specific and not ported.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import sys
from typing import Dict, Mapping, Tuple

import torch

from ..config import ModelConfig, TextConfig, VisionConfig
from .qwen25_vl.model import Qwen25VL

# safetensors dtype -> (torch dtype read from the bytes, dtype it is viewed as)
_DTYPES = {
    "F64": (torch.float64, torch.float64),
    "F32": (torch.float32, torch.float32),
    "F16": (torch.float16, torch.float16),
    "BF16": (torch.int16, torch.bfloat16),
    "I64": (torch.int64, torch.int64),
    "I32": (torch.int32, torch.int32),
    "I16": (torch.int16, torch.int16),
    "I8": (torch.int8, torch.int8),
    "U8": (torch.uint8, torch.uint8),
    "BOOL": (torch.bool, torch.bool),
}


def _normalise_keys(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Map any HF layout to canonical 'text.*' / 'visual.*' / 'lm_head' keys."""
    out = {}
    for k, v in sd.items():
        nk = k
        for prefix in ("model.language_model.", "language_model.model.", "language_model."):
            if nk.startswith(prefix):
                nk = "text." + nk[len(prefix):]
                break
        else:
            if nk.startswith("model.visual."):
                nk = "visual." + nk[len("model.visual."):]
            elif nk.startswith("visual."):
                pass
            elif nk.startswith("model."):
                nk = "text." + nk[len("model."):]
        out[nk] = v
    return out


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One safetensors file as CPU tensors viewing a copy-on-write memory
    map of it (the map stays open while a tensor refers to it)."""
    if sys.byteorder != "little":
        raise NotImplementedError("the safetensors reader assumes a little-endian host")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        stored, viewed = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = end - begin
        item = torch.empty((), dtype=stored).element_size()
        if count != item * int(torch.Size(shape).numel()):
            raise ValueError(f"{path}: tensor {name!r}: {count} bytes for shape {shape}")
        if count == 0:
            t = torch.empty(shape, dtype=stored)
        else:
            t = torch.frombuffer(buf, dtype=stored, count=count // item, offset=base + begin)
        out[name] = t.view(viewed).reshape(shape)
    return out


def load_safetensors_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every *.safetensors shard of a HF model directory, merged."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return sd


def config_from_hf_dir(model_dir: str) -> ModelConfig:
    """A ModelConfig from a HF config.json (qwen2_vl or qwen2_5_vl; text
    fields flat or nested under `text_config`)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    vis = raw.get("vision_config", {})
    is_qwen2 = raw.get("model_type") == "qwen2_vl"
    # the nested text_config (transformers >= 4.52) first, flat keys else
    hf = {**raw, **raw.get("text_config", {})}
    text_kw = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 1e6),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    if hf.get("rope_scaling") and "mrope_section" in hf["rope_scaling"]:
        text_kw["mrope_section"] = tuple(hf["rope_scaling"]["mrope_section"])
    if is_qwen2:
        d = vis.get("embed_dim", 1280)
        vis_kw = dict(
            variant="qwen2",
            depth=vis.get("depth", 32),
            hidden_size=d,
            intermediate_size=int(d * vis.get("mlp_ratio", 4)),
            num_heads=vis.get("num_heads", 16),
            spatial_merge_size=vis.get("spatial_merge_size", 2),
            patch_size=vis.get("patch_size", 14),
            temporal_patch_size=vis.get("temporal_patch_size", 2),
            out_hidden_size=vis.get("hidden_size", hf["hidden_size"]),
            tokens_per_second=1,
        )
    else:
        vis_kw = dict(
            depth=vis.get("depth", 32),
            hidden_size=vis.get("hidden_size", 1280),
            intermediate_size=vis.get("intermediate_size", 3420),
            num_heads=vis.get("num_heads", 16),
            window_size=vis.get("window_size", 112),
            fullatt_block_indexes=tuple(vis.get("fullatt_block_indexes", (7, 15, 23, 31))),
            spatial_merge_size=vis.get("spatial_merge_size", 2),
            patch_size=vis.get("patch_size", 14),
            temporal_patch_size=vis.get("temporal_patch_size", 2),
            out_hidden_size=vis.get("out_hidden_size", hf["hidden_size"]),
            tokens_per_second=vis.get("tokens_per_second", 2),
        )
    return ModelConfig(
        name="qwen2_vl_hf" if is_qwen2 else "qwen2_5_vl_hf",
        vision=VisionConfig(**vis_kw),
        text=TextConfig(**text_kw),
    )


_TEXT_LAYER = {  # port attribute -> HF name under text.layers.{i}.
    "input_ln": "input_layernorm",
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "o_proj": "self_attn.o_proj",
    "post_ln": "post_attention_layernorm",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}
_VISION_BLOCK = {  # port attribute -> HF name under visual.blocks.{i}. (those the block has)
    "norm1": "norm1",
    "norm2": "norm2",
    "qkv": "attn.qkv",
    "proj": "attn.proj",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}


def _module_tensors(m: Qwen25VL) -> Dict[str, Tuple[torch.Tensor, str]]:
    """Each parameter of the port's model -> (the parameter, its HF key in
    the normalised layout)."""
    pairs: Dict[str, Tuple[torch.Tensor, str]] = {}

    def add(mod, hf: str):
        for pname, p in mod.named_parameters(recurse=False):
            pairs[f"{hf}.{pname}"] = (p, f"{hf}.{pname}")

    lm, tower = m.text, m.vision
    add(lm.embed, "text.embed_tokens")
    add(lm.final_ln, "text.norm")
    if lm.lm_head is not None:
        add(lm.lm_head, "lm_head")
    for i, layer in enumerate(lm.layers):
        for attr, hf in _TEXT_LAYER.items():
            add(getattr(layer, attr), f"text.layers.{i}.{hf}")
    for i, blk in enumerate(tower.blocks):
        for attr, hf in _VISION_BLOCK.items():
            if hasattr(blk, attr):
                add(getattr(blk, attr), f"visual.blocks.{i}.{hf}")
    add(tower.ln_q, "visual.merger.ln_q")
    add(tower.merger_fc1, "visual.merger.mlp.0")
    add(tower.merger_fc2, "visual.merger.mlp.2")
    return pairs


@torch.no_grad()
def model_from_state_dict(
    cfg: ModelConfig,
    sd: Mapping[str, torch.Tensor],
    *,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Qwen25VL:
    """The port's model from a HF state dict (either layout), every weight
    cast from its stored dtype to `dtype` (round to nearest even, as the
    JAX package's params_from_state_dict casts), on the card unless the
    caller passes device="cpu". The patch embedding's Conv3d weight [D, C,
    tps, ps, ps] becomes the Linear [D, C * tps * ps * ps]."""
    sd = _normalise_keys(sd)
    with torch.device("meta"):
        m = Qwen25VL(cfg, dtype=dtype)
    m.to_empty(device=device)
    for p, key in _module_tensors(m).values():
        if key not in sd:
            raise KeyError(f"checkpoint has no {key!r} (normalised key)")
        p.copy_(sd[key].reshape(p.shape))
    pw = sd["visual.patch_embed.proj.weight"]
    m.vision.patch_embed.weight.copy_(pw.reshape(pw.shape[0], -1))
    return m.eval().requires_grad_(False)


def load_hf_checkpoint(
    model_dir: str, *, device="cuda", dtype: torch.dtype = torch.bfloat16
) -> Tuple[ModelConfig, Qwen25VL]:
    """(cfg, model) from a HF Qwen2-VL or Qwen2.5-VL directory (config.json
    + *.safetensors), built on the card unless the caller passes
    device="cpu"."""
    cfg = config_from_hf_dir(model_dir)
    return cfg, model_from_state_dict(cfg, load_safetensors_state_dict(model_dir),
                                      device=device, dtype=dtype)
