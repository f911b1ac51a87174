"""The port's sampling against the JAX package's: repetition penalty and
greedy exactly, the categorical draw by its distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.ops import sampling as js
from streaming_vlm_tpu_torch.ops import sampling as ts


@pytest.mark.parametrize("penalty", [1.0, 1.05, 1.3])
def test_repetition_penalty_bitwise(penalty):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=257).astype(np.float32) * 3
    presence = rng.random(257) < 0.3
    ref = js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(presence), penalty)
    got = ts.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence), penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_greedy_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        logits = rng.normal(size=97).astype(np.float32)
        presence = rng.random(97) < 0.5
        kw = dict(temperature=0.9, repetition_penalty=1.05, do_sample=False)
        ref = js.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(presence), **kw)
        got = ts.sample_token(None, torch.from_numpy(logits), torch.from_numpy(presence), **kw)
        assert int(got) == int(ref)


def test_categorical_distribution():
    """Frequencies of 40k draws match softmax((penalised logits) / T); the
    bound is ~6 standard errors of a 40k-sample frequency at p <= 0.5."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 3.0, -2.0, 1.5])
    presence = torch.tensor([False, True, False, False, True, True, False, False])
    T, pen, n = 0.9, 1.3, 40_000
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([
        ts.sample_token(g, logits, presence, temperature=T, repetition_penalty=pen, do_sample=True)
        for _ in range(n)
    ])
    freq = torch.bincount(draws, minlength=8).double() / n
    want = torch.softmax(ts.apply_repetition_penalty(logits, presence, pen).double() / T, 0)
    assert float((freq - want).abs().max()) < 6 * (0.25 / n) ** 0.5
    # and the JAX sampler draws from the same distribution
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    jd = jax.vmap(
        lambda k: js.sample_token(k, jnp.asarray(logits.numpy()), jnp.asarray(presence.numpy()),
                                  temperature=T, repetition_penalty=pen, do_sample=True)
    )(keys)
    jfreq = np.bincount(np.asarray(jd), minlength=8) / 4000
    assert np.abs(jfreq - want.numpy()).max() < 6 * (0.25 / 4000) ** 0.5
