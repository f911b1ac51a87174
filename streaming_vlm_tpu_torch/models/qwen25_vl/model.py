"""Full Qwen2-VL / Qwen2.5-VL model: vision tower + multimodal merge +
language model.

Port of streaming_vlm_tpu/models/qwen25_vl/model.py (both vision variants;
the decoders are the same), with the random W8A8 model of the JAX
package's ops/quant.py (`random_quantized_model`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...config import ModelConfig
from ...ops import quant
from . import language, vision
from .rope import mrope_positions_from_ids


class Qwen25VL(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.vision = vision.VisionTower(cfg.vision, **factory)
        self.text = language.LanguageModel(cfg.text, **factory)


def _init_float(module: nn.Module, generator: torch.Generator, device) -> None:
    """The JAX package's random scheme for float modules: matrices and
    embeddings ~ N(0, 1) * 0.02 drawn in f32 then cast, norms 1, biases 0."""
    for mod in module.modules():
        if isinstance(mod, language.RMSNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, vision.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            w = torch.randn(mod.weight.shape, generator=generator, device=device)
            mod.weight.copy_(w.mul_(0.02))
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()


@torch.no_grad()
def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    *,
    device="cuda",
    dtype=torch.float32,
) -> Qwen25VL:
    """Random model with the JAX package's scheme (language.py and
    vision.py init_*_params): matrices and embeddings ~ N(0, 1) * 0.02 drawn
    in f32 then cast, norms 1, biases 0. Built on the card unless the
    caller passes device="cpu"; the generator must live on `device`. The
    values differ from jax.random's (tests build both sides from one set of
    numpy weights through models/bridge.py instead)."""
    with torch.device("meta"):
        m = Qwen25VL(cfg, dtype=dtype)
    m.to_empty(device=device)
    _init_float(m, generator, device)
    return m.eval().requires_grad_(False)


@torch.no_grad()
def random_quantized_model(
    cfg: ModelConfig,
    generator: torch.Generator,
    *,
    device="cuda",
    dtype=torch.bfloat16,
) -> Qwen25VL:
    """Random W8A8 model built directly in the quantized layout (the same
    modules as quantize_model(init_params(...))), the port of the JAX
    package's random_quantized_model_params: decoder projections and the
    lm_head are uniform int8 in [-127, 127] with s = 0.02 / 127; embed ~
    N(0, 1) * 0.02, norms 1, biases 0, in `dtype`; the vision tower is
    random float, then quantized. The float decoder never exists: the 7B
    model takes ~8.8 GB, never ~16.6 GB of bf16 weights plus their copy."""
    tcfg = cfg.text
    with torch.device("meta"):
        m = Qwen25VL(cfg, dtype=dtype)
        for layer in m.text.layers:
            for name in quant.LAYER_LINEARS:
                lin = getattr(layer, name)
                setattr(layer, name, quant.QLinear(
                    lin.in_features, lin.out_features, lin.bias is not None, dtype=dtype))
        m.text.lm_head = quant.QLinear(tcfg.hidden_size, tcfg.vocab_size, bias=False, dtype=dtype)
    m.to_empty(device=device)
    _init_float(m, generator, device)
    for mod in m.text.modules():
        if isinstance(mod, quant.QLinear):
            mod.q.copy_(torch.randint(-127, 128, mod.q.shape, generator=generator,
                                      device=device, dtype=torch.int8))
            mod.s.fill_(0.02 / 127.0)
            if mod.bias is not None:
                mod.bias.zero_()
    quant.quantize_vision(m.vision)
    return m.eval().requires_grad_(False)


@torch.no_grad()
def encode_video(
    cfg: ModelConfig,
    model: Qwen25VL,
    pixel_patches: torch.Tensor,  # [S, in_ch * tps * ps * ps]
    grid_thw: Sequence[Tuple[int, int, int]],
) -> torch.Tensor:
    """Run the vision tower for the given grids. Returns [S // merge_unit, D_text]."""
    geo = model.vision.geometry(grid_thw, pixel_patches.device)
    return vision.vision_forward(cfg.vision, model.vision, pixel_patches, geo)


@torch.no_grad()
def encode_video_frames(
    cfg: ModelConfig,
    model: Qwen25VL,
    frames_u8,  # [T, H, W, 3] uint8: a tensor (on the model's device) or host numpy
    grid_thw: Tuple[int, int, int],
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """uint8 frames -> vision embeddings on the model's device: normalise and
    patchify there (`vision.patchify_on_device`), then the tower. Host
    frames are copied to the device first (StreamingEngine.upload_frames
    starts that copy ahead of time). Returns [S // merge_unit, D_text]."""
    dev = model.text.embed.weight.device
    frames = frames_u8 if isinstance(frames_u8, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(frames_u8, np.uint8))
    patches = vision.patchify_on_device(
        cfg.vision, frames.to(dev), out_dtype=dtype or model.vision.patch_embed.weight.dtype)
    return encode_video(cfg, model, patches, [tuple(int(x) for x in grid_thw)])


def merge_vision_embeds(
    embeds: torch.Tensor,  # [T, D] token embeddings
    vision_embeds: Optional[torch.Tensor],  # [N_vis, D]
    vision_slots: Optional[torch.Tensor],  # [N_vis] int64 rows of video/image tokens
) -> torch.Tensor:
    """Scatter vision embeddings into their token slots. Slots >= T are
    dropped (the JAX scatter's mode="drop"); embeds is updated in place."""
    if vision_embeds is None:
        return embeds
    keep = vision_slots < embeds.shape[0]
    embeds[vision_slots[keep]] = vision_embeds[keep].to(embeds.dtype)
    return embeds


@torch.no_grad()
def forward_full(
    cfg: ModelConfig,
    model: Qwen25VL,
    input_ids: np.ndarray,  # [T] host ints
    *,
    pixel_patches: Optional[torch.Tensor] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[Sequence[float]] = None,
    image_grid_thw: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Offline full-attention forward (the parity oracle): [T, V] f32 logits."""
    ids_np = np.asarray(input_ids).reshape(-1)
    positions, _ = mrope_positions_from_ids(
        ids_np,
        video_grid_thw,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        tokens_per_second=cfg.vision.tokens_per_second,
        second_per_grid_ts=second_per_grid_ts,
        image_grid_thw=image_grid_thw,
        video_token_id=cfg.tokens.video_pad,
        image_token_id=cfg.tokens.image_pad,
    )
    dev = model.text.embed.weight.device
    ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
    embeds = language.embed_tokens(cfg.text, model.text, ids)
    if pixel_patches is not None:
        grids = video_grid_thw if video_grid_thw is not None else image_grid_thw
        pad_id = cfg.tokens.video_pad if video_grid_thw is not None else cfg.tokens.image_pad
        vis = encode_video(cfg, model, pixel_patches, [tuple(int(x) for x in g) for g in grids])
        (slots,) = np.nonzero(ids_np == pad_id)
        embeds = merge_vision_embeds(embeds, vis, torch.from_numpy(slots).to(dev))
    hidden = language.language_forward(
        cfg.text, model.text, embeds, torch.from_numpy(positions).to(dev)
    )
    return language.lm_logits(cfg.text, model.text, hidden)
