"""The row pass of the fused linear cross-entropy: kernel CE-row
(csrc/linear_ce.cu) and its plain PyTorch version.

`ce_rows(logits, targets, mask, with_grads)` takes one chunk's f32 logits
[rows, V] and writes each row's masked NLL (log-sum-exp minus the target
logit, times the mask) and, with grads, dlog = (softmax - onehot(target)) *
mask over the logits in place, so the chunk's gradient needs no second
[rows, V] buffer (1.25 GB at 2048 rows of the 7B vocabulary). It replaces
no Pallas kernel: the JAX package computes this pass in XLA inside
`fused_linear_ce` (streaming_vlm_tpu/train/step.py `_fused_ce_pass`);
train/step.py calls it once a chunk. On a CUDA tensor it launches the
kernel (f32 logits, int targets, contiguous; anything else raises) and
counts the launch in `launch_counts`; on a CPU tensor it runs the plain
version, which repeats the JAX pass's arithmetic.
"""

from __future__ import annotations

import torch

from ._kernels import check_cuda, ptr, stream

launch_counts = {"ce_rows": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def ce_rows_plain(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                  with_grads: bool) -> torch.Tensor:
    """The JAX pass's row math in f32: mx = max, p = exp(x - mx), l = sum p,
    nll = (log l + mx - x[target]) * mask; with grads, logits <- (p / l -
    onehot) * mask in place. Returns nll [rows] f32."""
    m = mask.float()
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - mx)
    l = p.sum(dim=-1, keepdim=True)
    tgt = logits.gather(1, targets.long()[:, None])[:, 0]
    nll = (torch.log(l[:, 0]) + mx[:, 0] - tgt) * m
    if with_grads:
        dlog = p / l
        dlog[torch.arange(len(dlog), device=dlog.device), targets.long()] -= 1.0
        logits.copy_(dlog * m[:, None])
    return nll


def ce_rows(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            with_grads: bool) -> torch.Tensor:
    """CE-row over f32 logits [rows, V] with targets [rows] in [0, V) and a
    0/1 mask [rows]: returns the masked NLL [rows] f32; with_grads also
    overwrites logits with dlog. One counted launch on the card."""
    if logits.device.type == "cpu":
        return ce_rows_plain(logits, targets, mask, with_grads)
    name = "ce_rows"
    rows, V = logits.shape
    if logits.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes f32 logits, got {logits.dtype}")
    if targets.shape != (rows,) or mask.shape != (rows,):
        raise ValueError(f"{name}: targets and mask must be [{rows}]")
    tgt = targets.to(torch.int32).contiguous()
    mk = mask.to(torch.float32).contiguous()
    check_cuda(name, logits, tgt, mk)
    from ._kernels import lib

    nll = torch.empty(rows, dtype=torch.float32, device=logits.device)
    err = lib().svt_ce_rows(ptr(logits), ptr(tgt), ptr(mk), ptr(nll), rows, V, int(with_grads),
                            stream())
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launch_counts[name] += 1
    return nll
