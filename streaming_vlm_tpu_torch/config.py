"""Model, stream, sampling and video configuration of the port.

A copy of the JAX package's `streaming_vlm_tpu/config.py` (the dataclasses
and the Qwen2.5-VL and Qwen2-VL presets), with the same field names and defaults, so
that one configuration means the same thing on either side;
tests/test_torch_imports.py holds the two equal field for field. The port
reads no environment variable: every choice goes through these dataclasses.

Defaults reproduce the reference's operating point: FPS=2, chunk=1s, vision
window 16s, text rounds 16, text sink 512, text sliding window 512, <=20
tokens/chunk, temperature 0.9, repetition penalty 1.05.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Qwen2/2.5-VL vision tower configuration.

    variant='qwen2_5': RMSNorm, SwiGLU MLP, windowed attention with
    fullatt_block_indexes. variant='qwen2': LayerNorm(+bias), fc1/quick_gelu/
    fc2 MLP, full (per-temporal-slice) attention in every block."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 2048
    tokens_per_second: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    variant: str = "qwen2_5"  # {"qwen2_5", "qwen2"}

    @property
    def use_windows(self) -> bool:
        return self.variant == "qwen2_5"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Qwen2.5-VL language model configuration."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = True


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Qwen2/2.5-VL special token ids."""

    im_start: int = 151644
    im_end: int = 151645
    vision_start: int = 151652
    vision_end: int = 151653
    image_pad: int = 151655
    video_pad: int = 151656
    newline: int = 198
    user: int = 872
    assistant: int = 77091
    previous_text: Tuple[int, int] = (19702, 1467)
    time_word: int = 1462
    pad: int = 151643  # <|endoftext|>


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full VLM configuration."""

    name: str = "qwen2_5_vl"
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    tokens: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    dtype: str = "bfloat16"  # parameter / activation dtype


def qwen25_vl_3b() -> ModelConfig:
    """Qwen2.5-VL-3B-Instruct."""
    return ModelConfig(
        name="qwen2_5_vl_3b",
        vision=VisionConfig(out_hidden_size=2048),
        text=TextConfig(
            vocab_size=151936,
            hidden_size=2048,
            intermediate_size=11008,
            num_hidden_layers=36,
            num_attention_heads=16,
            num_key_value_heads=2,
            head_dim=128,
            tie_word_embeddings=True,
        ),
    )


def qwen25_vl_7b() -> ModelConfig:
    """Qwen2.5-VL-7B-Instruct (the StreamingVLM checkpoint base)."""
    return ModelConfig(
        name="qwen2_5_vl_7b",
        vision=VisionConfig(out_hidden_size=3584),
        text=TextConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            head_dim=128,
            tie_word_embeddings=False,
        ),
    )


def qwen25_vl_tiny(vocab_size: int = 1024) -> ModelConfig:
    """Tiny random config for CPU-runnable tests. Special-token ids are
    remapped into the tiny vocab so multimodal sequences are embeddable."""
    return ModelConfig(
        name="qwen2_5_vl_tiny",
        tokens=SpecialTokens(
            im_start=1001,
            im_end=1002,
            vision_start=1003,
            vision_end=1004,
            image_pad=1005,
            video_pad=1006,
            newline=10,
            user=20,
            assistant=21,
            previous_text=(22, 23),
            time_word=24,
            pad=0,
        ),
        vision=VisionConfig(
            depth=4,
            hidden_size=64,
            intermediate_size=128,
            num_heads=4,
            window_size=28,  # -> merger window of 1 llm-grid cell
            fullatt_block_indexes=(1, 3),
            out_hidden_size=64,
        ),
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            mrope_section=(2, 3, 3),  # sums to head_dim // 2
            tie_word_embeddings=False,
        ),
    )


def qwen2_vl_7b() -> ModelConfig:
    """Qwen2-VL-7B-Instruct."""
    return ModelConfig(
        name="qwen2_vl_7b",
        vision=VisionConfig(
            variant="qwen2",
            depth=32,
            hidden_size=1280,
            intermediate_size=5120,  # mlp_ratio 4
            num_heads=16,
            out_hidden_size=3584,
            tokens_per_second=1,
        ),
        text=TextConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            head_dim=128,
            tie_word_embeddings=False,
        ),
    )


def qwen2_vl_tiny(vocab_size: int = 1024) -> ModelConfig:
    """Tiny Qwen2-VL variant for CPU parity tests."""
    base = qwen25_vl_tiny(vocab_size)
    return dataclasses.replace(
        base,
        name="qwen2_vl_tiny",
        vision=dataclasses.replace(
            base.vision, variant="qwen2", intermediate_size=256, tokens_per_second=1
        ),
    )


PRESETS = {
    "tiny": qwen25_vl_tiny,
    "3b": qwen25_vl_3b,
    "7b": qwen25_vl_7b,
    "qwen2_7b": qwen2_vl_7b,
    "qwen2_tiny": qwen2_vl_tiny,
}


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming KV-policy configuration."""

    fps: float = 2.0
    chunk_duration: float = 1.0
    window_size: int = 16  # seconds of vision kept (visual_round = window/chunk)
    text_round: int = 16  # assistant turns kept verbatim
    text_sink: Optional[int] = 512  # first N previous-text tokens kept forever
    text_sliding_window: Optional[int] = 512  # last N previous-text tokens kept
    max_tokens_per_chunk: int = 20
    pos_mode: str = "shrink"  # {"shrink", "append"}
    all_text: bool = False  # 1-D RoPE for everything (LiveCC compat)
    # Static arena capacity (slots): the default operating point holds up to
    # ~10k live slots plus the in-flight chunk's padding.
    kv_capacity: int = 10240
    # the 640 bucket keeps the default chunk (512 video tokens + ~20
    # scaffold) from padding to 1024, which would not fit a full arena
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 640, 1024, 2048, 4096)
    # Rotate the whole arena K once per chunk into a second [L, C, Hkv, hd]
    # copy in the engine dtype (prefill through K1's pre-rotated mode,
    # decode through K2), or keep only the raw arena and rotate at attention
    # time from per-slot positions (K1's raw mode, decode through K3). None
    # = auto: pre-rotate while the arena has <= 32k slots.
    prerotate_arena: Optional[bool] = None
    # KV-arena storage: "none" (engine dtype) or "int8" (per-(slot, head)
    # symmetric scales over head_dim, ops/quant.py quantize_kv): half the
    # arena's bytes. Blocks are quantized as they are merged; the per-chunk
    # rotated K copy and the decode delta stay in the engine dtype.
    kv_quant: str = "none"
    # Decode attention over a raw arena (prerotate off): None (default) or
    # True run kernel K3 (ops/attention.py streaming_decode_attention_int8),
    # which reads the arena in its storage form and dequantizes and rotates
    # in the kernel. False (the JAX package's jnp route) is not offered:
    # the port's engine raises on it. The field stays so that one
    # configuration means the same in both packages.
    decode_int8_kernel: Optional[bool] = None
    # Storage of the per-chunk rotated K copy: "none" (engine dtype) or
    # "int8" (requantized per (slot, head), the raw int8 arena's bytes; what
    # fits 8 streams of 7B at C = 10240 with the pre-rotated path).
    rot_quant: str = "none"

    @property
    def effective_prerotate(self) -> bool:
        if self.prerotate_arena is not None:
            return self.prerotate_arena
        return self.kv_capacity <= 32768

    @property
    def visual_round(self) -> int:
        n, d = self.window_size, self.chunk_duration
        r = int(n / d)
        if r * d != n:
            raise ValueError("window_size must be divisible by chunk_duration")
        return r


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Per-token sampling configuration."""

    temperature: float = 0.9
    repetition_penalty: float = 1.05
    do_sample: bool = True
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Video ingest pixel budgets."""

    fps: float = 2.0
    frame_factor: int = 2
    video_min_pixels: int = 100 * 28 * 28
    video_max_pixels: int = 512 * 28 * 28
    video_total_pixels: int = 20480 * 28 * 28
    patch_factor: int = 28  # patch_size * spatial_merge_size

    def max_pixels_for_window(self, window_size: int) -> int:
        nframes = self.fps * window_size
        return int(
            max(
                min(self.video_max_pixels, self.video_total_pixels / nframes * self.frame_factor),
                int(self.video_min_pixels * 1.05),
            )
        )
