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


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One intra-op thread for the module's tests, restored after it. The
    tiny models' many small ops gain nothing from more, and with several
    test processes sharing the machine's cores (pytest-xdist) each
    process's spinning thread pool slows every op many times over (a file
    measured 16 s alone took 826 s beside five copies of itself at 8
    threads each, 27 s at one). Only for modules whose results do not
    depend on it: a reduction's order can change with the thread count, and
    an engine with int8 activations can turn that into other tokens
    (tests/test_torch_w4a8.py's engine parity holds at the default count):

    from _torch_cpu import one_cpu_thread  # noqa: F401  (autouse fixture)
"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

