"""Token sampling: repetition penalty + temperature + categorical/greedy.

Port of streaming_vlm_tpu/ops/sampling.py. Order matches HF's logits
processors: repetition penalty on raw logits, then temperature, then
argmax (greedy) or a categorical draw. The draw is Gumbel-max with noise
from an explicit `torch.Generator`, so it needs no host sync; it cannot
reproduce jax.random's bits, only its distribution.
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_repetition_penalty(
    logits: torch.Tensor,  # [V] float32
    presence: torch.Tensor,  # [V] bool — token appears in the current sequence
    penalty: float,
) -> torch.Tensor:
    if penalty == 1.0:
        return logits
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalised, logits)


def sample_token(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # [V] float32
    presence: torch.Tensor,  # [V] bool
    *,
    temperature: float,
    repetition_penalty: float,
    do_sample: bool,
) -> torch.Tensor:
    """Returns a 0-d int64 token id on logits' device."""
    scores = apply_repetition_penalty(logits, presence, repetition_penalty)
    if not do_sample:
        return torch.argmax(scores)
    scores = scores / max(temperature, 1e-6)
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    gumbel = -torch.log(-torch.log(u))  # u == 0 gives -inf: never chosen
    return torch.argmax(scores + gumbel)
