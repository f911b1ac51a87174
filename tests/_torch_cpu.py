"""Shared set-up of the PyTorch port's CPU tests.

PyTorch's CPU build (seen with torch 2.13) sometimes computes the first
vectorised transcendental function (exp, sin, log, ...) that an intra-op
worker thread runs with an error of ~1e-4 (relative, for exp) on that
thread's share of the tensor; every later call is accurate to the usual
ulp. Run as the first such call of a fresh process, a parity check then
fails about one time in sixty per op. One call over a tensor large enough to
reach every worker thread, before the module's tests, keeps that call out
of them:

    from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def warm_cpu_math():
    torch.exp(torch.zeros(1 << 20))
