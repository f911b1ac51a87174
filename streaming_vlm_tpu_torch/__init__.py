"""streaming-vlm-tpu's PyTorch + CUDA port (one NVIDIA H100).

Mirrors the layout of the JAX package `streaming_vlm_tpu`, which stays the
reference it is tested against. The serving path runs here:
`serve.streaming_inference` / `serve.streaming_inference_frames` ->
`streaming.engine.StreamingEngine` -> `models.qwen25_vl` with the
hand-written Hopper kernels of `ops.attention` and `ops.quant` (sources in
`csrc/`), and so do multi-stream serving, training, the evaluation
harnesses (`eval/`), the LiveCC baseline, the demo and the command line
(`python -m streaming_vlm_tpu_torch`). Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
