"""Model, stream, sampling and video configuration of the port.

The dataclasses are the JAX package's `streaming_vlm_tpu.config`, which
imports no jax (the package's `__init__` imports only `config`): one
definition serves both packages, so a configuration means the same thing on
either side. The port's modules and callers take them from here.
"""

from streaming_vlm_tpu.config import (  # noqa: F401
    ModelConfig,
    SamplingConfig,
    SpecialTokens,
    StreamConfig,
    TextConfig,
    VideoConfig,
    VisionConfig,
    qwen25_vl_3b,
    qwen25_vl_7b,
    qwen25_vl_tiny,
)
