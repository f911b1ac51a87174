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

import numpy as np
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



def numpy_params(cfg, seed: int = 0):
    """A JAX-package parameter tree for cfg (`model.init_params`'s leaves and
    shapes) as f32 numpy arrays from a numpy generator: norms 1 + N(0, 0.1),
    every other leaf N(0, 1) * 0.02. Both sides of a parity test take the
    same weights from it (the port's through `models/bridge.from_jax_params`);
    it skips init_params' eager jax.random calls, each compiled on its own
    (~7 s on the tiny model)."""
    import jax

    from streaming_vlm_tpu.models.qwen25_vl import model as jmodel

    shapes = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if ("ln" in name or "norm" in name) and not name.endswith("_b']"):
            return np.float32(1.0) + np.float32(0.1) * x
        return np.float32(0.02) * x

    return jax.tree_util.tree_map_with_path(fill, shapes)
