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


def sample_tokens(
    generators,  # one Optional[torch.Generator] per lane; None: the lane draws no noise
    logits: torch.Tensor,  # [B, V] float32
    presence: torch.Tensor,  # [B, V] bool
    *,
    temperature: float,
    repetition_penalty: float,
    do_sample: bool,
) -> torch.Tensor:
    """One token per lane ([B] int64 on logits' device). Sampled lanes draw
    their Gumbel noise from their own generator, one [V] draw per step, so
    a lane's tokens are those of a solo stream seeded the same way. A lane
    whose generator is None (an idle lane of a multi-stream round, whose
    output is discarded) draws nothing: its generator does not advance."""
    scores = apply_repetition_penalty(logits, presence, repetition_penalty)
    if not do_sample:
        return torch.argmax(scores, dim=-1)
    scores = scores / max(temperature, 1e-6)
    V, dev = scores.shape[-1], scores.device
    # an idle lane's u = 1/e: the same noise (~0) on every token
    u = torch.stack([torch.full((V,), 0.36787944117144233, device=dev) if g is None
                     else torch.rand(V, generator=g, device=dev) for g in generators])
    gumbel = -torch.log(-torch.log(u))  # u == 0 gives -inf: never chosen
    return torch.argmax(scores + gumbel, dim=-1)


def sample_token(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # [V] float32
    presence: torch.Tensor,  # [V] bool
    *,
    temperature: float,
    repetition_penalty: float,
    do_sample: bool,
) -> torch.Tensor:
    """Returns a 0-d int64 token id on logits' device (a sampled draw with
    generator None uses PyTorch's default generator)."""
    if do_sample and generator is None:
        generator = torch.default_generator if logits.device.type == "cpu" else \
            torch.cuda.default_generators[logits.device.index or 0]
    return sample_tokens(
        [generator], logits[None], presence[None], temperature=temperature,
        repetition_penalty=repetition_penalty, do_sample=do_sample,
    )[0]
