"""The port's parallel training modes (streaming_vlm_tpu_torch/parallel/
ring.py, pipeline.py, tp.py and the Trainer's mesh modes) against the JAX
package's `parallel/` functions on conftest's 8 virtual CPU devices, jitted
(tests/test_ring.py says why), in one gloo world of 4 CPU ranks spawned for
the file (tests/_torch_world.py; 2-rank meshes take the world's first two
ranks): ring-attention sequence parallelism (S = 2 and 4, with remat, with a
vision scatter, and ("data", "seq")), GPipe (S = 2 and 4, remat, vision,
("data", "stage")), and one Trainer step in gspmd (FSDP over 'data' x TP
over 'model'), pp and sp against the JAX Trainer's step. Tolerances: the
JAX tests' own (tests/test_ring.py, tests/test_pipeline.py), or the port's
one-card parity tolerance (tests/test_torch_train.py: each leaf within
1e-5 + 1e-4 of its largest |value|) where that is looser."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_parallel_cases as C
from _torch_cpu import numpy_params
from _torch_world import World
from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.parallel import pipeline as jpp
from streaming_vlm_tpu.parallel import ring as jring
from streaming_vlm_tpu.parallel.mesh import make_mesh

CFG = qwen25_vl_tiny()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def tree():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(B=2, T=64, seed=0, vision=False):
    """tests/test_ring.py's batch; with `vision`, 6 vision rows a example
    scattered in (the last one past T: dropped)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(5, 900, size=(B, T)).astype(np.int32)
    for b in range(B):
        labels[b, : 7 + 2 * b] = -100
    out = {"input_ids": rng.integers(5, 900, size=(B, T)).astype(np.int32), "labels": labels,
           "positions": np.broadcast_to(np.arange(T, dtype=np.float32), (B, 3, T)).copy()}
    if vision:
        out["vis_embeds"] = (rng.standard_normal((B, 6, CFG.text.hidden_size)) * 0.3
                             ).astype(np.float32)
        out["vis_slots"] = np.stack([np.r_[np.sort(rng.choice(T // 2, 5, replace=False)), T]
                                     for _ in range(B)]).astype(np.int32)
    return out


def _torch_batch(batch):
    return {k: v.astype(np.int64) if v.dtype == np.int32 else v for k, v in batch.items()}


def _jax_grads(g_text) -> dict:
    """The JAX text gradient tree in `_torch_parallel_cases.text_grads`' keys."""
    out = {("embed",): np.asarray(g_text["embed"]), ("final_ln",): np.asarray(g_text["final_ln"])}
    if "lm_head" in g_text:
        out[("lm_head",)] = np.asarray(g_text["lm_head"])
    for k, v in g_text["layers"].items():
        for i, x in enumerate(np.asarray(v)):
            out[(k, i)] = x
    return out


def _merge(results) -> tuple:
    """(loss, count, gradients) from the ranks' results (a stage's layers
    from each rank; the rest equal on every rank)."""
    got = [r for r in results if r is not None]
    grads = {}
    for r in got:
        grads.update(r[2])
    assert len({(r[0], r[1]) for r in got}) == 1, [r[:2] for r in got]
    return got[0][0], got[0][1], grads


def _close(got: dict, want: dict, rtol: float, atol: float) -> None:
    """Each leaf within the JAX test's rtol / atol or the port's parity
    tolerance (1e-5 + 1e-4 of the leaf's largest |value|), the looser."""
    assert set(got) == set(want)
    for k, w in want.items():
        limit = np.maximum(atol + rtol * np.abs(w), 1e-5 + 1e-4 * np.abs(w).max())
        err = np.abs(got[k] - w)
        assert (err <= limit).all(), (k, float(err.max()))


@pytest.fixture(scope="module")
def jax_loss_grads(jparams):
    """jitted value_and_grad of JAX's sft_loss_sp ("sp") or sft_loss_pp
    ("pp") over the text parameters on a mesh, cached by (name, mesh shape,
    batch key)."""
    cache = {}

    def get(name, shape, batch_key, batch, remat="none"):
        key = (name, tuple(sorted(shape.items())), batch_key, remat)
        if key not in cache:
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            mesh, loss_fn = make_mesh(shape), {"sp": jring.sft_loss_sp, "pp": jpp.sft_loss_pp}[name]
            fn = lambda tp: loss_fn(CFG, {**jparams, "text": tp}, jb, mesh, remat=remat)  # noqa: E731
            (loss, count), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(jparams["text"])
            cache[key] = (float(loss), int(count), _jax_grads(g))
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# ring attention (sp)


@pytest.mark.parametrize("shards", [2, 4])
def test_sp_forward_matches_jax(world, tree, jparams, shards):
    """sp_language_forward's hidden states equal JAX's (test_ring.py's
    rtol 1e-4 / atol 1e-5) on every rank."""
    rng = np.random.default_rng(1)
    B, T, D = 2, 64, CFG.text.hidden_size
    x = (rng.normal(size=(B, T, D)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.float32), (B, 3, T)).copy()
    want = np.asarray(jax.jit(lambda p, a, b: jring.sp_language_forward(
        CFG.text, p, a, b, make_mesh({"seq": shards})))(jparams["text"], x, pos))
    got = [r for r in world.run(C.sp_forward, tree, {"seq": shards}, x, pos) if r is not None]
    assert len(got) == shards
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["seq2-vision", "seq4", "seq2-remat-full", "data2-seq2"])
def test_sp_loss_and_grads_match_jax(world, tree, jax_loss_grads, case):
    """sft_loss_sp's loss, count and text gradients (the whole gradient on
    every rank) equal JAX's sft_loss_sp (test_ring.py's rtol 2e-5 on the
    loss; gradients rtol 3e-4 / atol 1e-5 or the port's parity tolerance)."""
    shape = {"seq2-vision": {"seq": 2}, "seq4": {"seq": 4}, "seq2-remat-full": {"seq": 2},
             "data2-seq2": {"data": 2, "seq": 2}}[case]
    vision = case == "seq2-vision"
    remat = "full" if "remat" in case else "none"
    B = 4 if "data" in shape else 2
    batch = _batch(B=B, T=64 if B == 2 else 32, seed=3 if B == 4 else 0, vision=vision)
    # the JAX reference: its own sp function on the same mesh (remat
    # leaves its gradients as they are: tests/test_ring.py)
    jl, jc, jg = jax_loss_grads("sp", shape, (B, vision), batch)
    res = world.run(C.train_loss, tree, "sp", shape, _torch_batch(batch), remat)
    got = [r for r in res if r is not None]
    assert len(got) == int(np.prod(list(shape.values())))
    for loss, count, grads in got:  # every rank: the whole loss and gradient
        assert count == jc
        np.testing.assert_allclose(loss, jl, rtol=2e-5)
        _close(grads, jg, rtol=3e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# pipeline (pp)


def test_pp_forward_matches_jax(world, tree, jparams):
    """pipeline_language_forward's [M, T, D] (pre-final-norm) equals JAX's
    on 4 stages (test_pipeline.py's 2e-6, or the port's parity
    tolerance)."""
    rng = np.random.default_rng(1)
    M, T, D = 3, 32, CFG.text.hidden_size
    x = (rng.normal(size=(M, T, D)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.float32), (M, 3, T)).copy()
    want = np.asarray(jax.jit(lambda lp, a, b: jpp.pipeline_language_forward(
        CFG.text, lp, a, b, make_mesh({"stage": 4})))(jparams["text"]["layers"], x, pos))
    for got in world.run(C.pp_forward, tree, {"stage": 4}, x, pos):
        _close({"h": got}, {"h": want}, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("case", ["stage2-vision", "stage4", "stage2-remat-dots",
                                  "data2-stage2"])
def test_pp_loss_and_grads_match_jax(world, tree, jax_loss_grads, case):
    """sft_loss_pp's loss and text gradients (each layer's on the rank that
    holds it, the replicated ones on every rank) equal JAX's sft_loss_pp
    (test_pipeline.py's rtol 1e-6 on the loss, gradients rtol 5e-5 / atol
    1e-6, or the port's parity tolerance)."""
    shape = {"stage2-vision": {"stage": 2}, "stage4": {"stage": 4},
             "stage2-remat-dots": {"stage": 2}, "data2-stage2": {"data": 2, "stage": 2}}[case]
    vision = case == "stage2-vision"
    remat = "dots" if "remat" in case else "none"
    batch = _batch(B=4, T=48, vision=vision)
    jl, jc, jg = jax_loss_grads("pp", shape, (4, vision), batch)
    res = world.run(C.train_loss, tree, "pp", shape, _torch_batch(batch), remat)
    loss, count, grads = _merge(res)
    assert count == jc
    np.testing.assert_allclose(loss, jl, rtol=2e-6)
    _close(grads, jg, rtol=5e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the Trainer


@pytest.fixture(scope="module")
def jax_trainer_step(jparams, tmp_path_factory):
    """The JAX Trainer's first step (gspmd, one device) on tests/
    test_pipeline.py's trainer batch: its metrics. JAX's pp / sp / meshed
    steps equal it (tests/test_pipeline.py, tests/test_mesh.py)."""
    from streaming_vlm_tpu.train.trainer import TrainConfig, Trainer

    batch = _batch(B=2, T=48, seed=11)
    tc = TrainConfig(output_dir=str(tmp_path_factory.mktemp("jax_trainer")), max_steps=2,
                     warmup_steps=1, grad_accum=1, remat="none")
    tr = Trainer(CFG, jparams, tc)
    _, _, m = tr._jit_step(tr.params["text"], tr.opt_state, tr.params["vision"],
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("mode,shape", [
    ("gspmd", {"data": 2}), ("gspmd", {"data": 2, "model": 2}), ("pp", {"stage": 4}),
    ("sp", {"seq": 4}), ("pp", {"data": 2, "stage": 2}), ("pp-step", {"stage": 2})],
    ids=["gspmd-data2", "gspmd-data2-model2", "pp-stage4", "sp-seq4", "pp-data2-stage2",
         "make_train_step_pp-stage2"])
def test_trainer_step_matches_jax(world, tree, jax_trainer_step, tmp_path, mode, shape):
    """One Trainer step under each mode (and one step of
    parallel/pipeline.make_train_step_pp): loss, labeled_tokens and grad_norm
    equal the JAX Trainer's (test_pipeline.py's rtol 1e-6 on the loss, 2e-5
    for sp; the grad norm rtol 1e-4 as tests/test_torch_train.py); the
    replicated text parameters end the step equal on every rank; under
    gspmd each rank's AdamW moments are its shards' size."""
    batch, want = jax_trainer_step
    res = [r for r in world.run(C.trainer_step, tree, mode, shape, _torch_batch(batch),
                                str(tmp_path)) if r is not None]
    assert len(res) == int(np.prod(list(shape.values())))
    for metrics, rep, moments in res:
        np.testing.assert_allclose(metrics["loss"], want["loss"],
                                   rtol=2e-5 if mode == "sp" else 1e-6)
        assert metrics["labeled_tokens"] == want["labeled_tokens"]
        np.testing.assert_allclose(metrics["grad_norm"], want["grad_norm"], rtol=1e-4)
        for k, v in rep.items():
            np.testing.assert_array_equal(v, res[0][1][k], err_msg=k)
    if mode == "gspmd":  # FSDP x TP: a rank holds about 1 / (data * model) of the moments
        n = int(np.prod(list(shape.values())))
        full = 2 * 4 * sum(np.asarray(v).size for v in tree["text"].values()
                           if not isinstance(v, dict))
        full += 2 * 4 * sum(np.asarray(v).size for v in tree["text"]["layers"].values())
        assert all(m <= full / n * 1.05 for _, _, m in res), ([m for *_, m in res], full / n)
