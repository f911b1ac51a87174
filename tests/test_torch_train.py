"""SFT training on the port (streaming_vlm_tpu_torch/train) against the JAX
package on the same numpy-made inputs and the same weights
(`from_jax_params`, gradients back through `to_jax_params`), in f32 on the
CPU: fused_linear_ce and chunked_cross_entropy (value and gradients),
sft_loss and its gradients on the tiny model (frozen-tower route, the
tower inside the loss with freeze_vision=False, remat "none" / "full" /
"dots"), the optimizer against optax over updates with a clipped one, lr
0 at count 0 and MultiSteps boundaries, and the Trainer against the JAX
Trainer (metrics rows, losses, final weights), with run-and-resume and
prefetch equal to synchronous."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_cpu import numpy_params, one_cpu_thread  # noqa: F401  (autouse fixture)
from streaming_vlm_tpu.config import VideoConfig as JVideo
from streaming_vlm_tpu.config import qwen25_vl_tiny as j_tiny
from streaming_vlm_tpu.data.dataset import StreamDataset as JDataset
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer as JFakeTokenizer
from streaming_vlm_tpu.train import step as jstep
from streaming_vlm_tpu.train import trainer as jtrainer
from streaming_vlm_tpu.video import ingest as jingest
from streaming_vlm_tpu_torch.config import VideoConfig, qwen25_vl_tiny
from streaming_vlm_tpu_torch.data.dataset import StreamDataset
from streaming_vlm_tpu_torch.models.bridge import from_jax_params, to_jax_params
from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu_torch.train import step as tstep
from streaming_vlm_tpu_torch.train import trainer as ttrainer

JCFG, CFG = j_tiny(), qwen25_vl_tiny()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def _assert_trees_close(got, want, rel=1e-4, atol=1e-5):
    """Leaf by leaf: |got - want| <= atol + rel * max |want leaf|."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for name in w:
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(g[name], w[name], rtol=0,
                                   atol=atol + rel * float(np.abs(w[name]).max()), err_msg=name)


@pytest.fixture(scope="module")
def weights():
    """The tiny model's f32 weights, as a JAX tree and as numpy."""
    np_params = numpy_params(JCFG)
    return jax.tree_util.tree_map(jnp.asarray, np_params), np_params


def _port_model(np_params, cfg=None):
    return from_jax_params(cfg or CFG, np_params, device="cpu")


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("chunk", [2048, 16], ids=["one_chunk", "chunks16"])
def test_fused_linear_ce_equals_jax(monkeypatch, chunk):
    """Value and both gradients of the masked NLL sum == the JAX custom_vjp's
    (rtol 1e-6 / atol 1e-5), in one chunk and in ragged chunks of 16; under
    no_grad the value alone."""
    monkeypatch.setattr(jstep, "FUSED_CE_CHUNK", chunk)
    monkeypatch.setattr(tstep, "FUSED_CE_CHUNK", chunk)
    rng = np.random.default_rng(3)
    T, D, V = 70, 24, 91
    h = rng.standard_normal((T, D), np.float32)
    w = rng.standard_normal((D, V), np.float32) * 0.1
    t = (np.arange(T, dtype=np.int32) * 7) % V
    m = np.arange(T) % 4 != 1
    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(
        lambda h, w: jstep.fused_linear_ce(h, w, jnp.asarray(t), jnp.asarray(m)), argnums=(0, 1)))(
            jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()  # [V, D]
    loss = tstep.fused_linear_ce(th, tw, torch.from_numpy(t).long(), torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jgw), atol=1e-5)
    with torch.no_grad():
        again = tstep.fused_linear_ce(th, tw, torch.from_numpy(t).long(), torch.from_numpy(m))
    assert float(again) == float(loss.detach())


def test_chunked_cross_entropy_equals_jax(monkeypatch):
    """Per-token NLLs and the gradients of their weighted sum == JAX's
    chunked_cross_entropy, over ragged chunks of 16 rows."""
    monkeypatch.setattr(jstep, "CE_CHUNK", 16)
    monkeypatch.setattr(tstep, "CE_CHUNK", 16)
    rng = np.random.default_rng(4)
    T, D, V = 45, 16, 77
    h = rng.standard_normal((T, D), np.float32)
    w = rng.standard_normal((D, V), np.float32) * 0.2
    t = rng.integers(0, V, T).astype(np.int32)
    c = rng.standard_normal(T).astype(np.float32)

    def jf(h, w):
        nll = jstep.chunked_cross_entropy(h, w, jnp.asarray(t))
        return jnp.sum(nll * c), nll

    (_, jnll), (jgh, jgw) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    nll = tstep.chunked_cross_entropy(th, tw, torch.from_numpy(t).long())
    (nll * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jgw), atol=1e-5)


def _text_batch(rng, B=2, T=64, n_vis=12):
    """Random ids, labels with ignored spans, mRoPE-shaped positions, and
    vision embeddings on random slots (the last two out of range: dropped)."""
    D = CFG.text.hidden_size
    ids = rng.integers(5, 900, (B, T)).astype(np.int32)
    labels = ids.copy()
    labels[:, : T // 3] = -100
    labels[:, T // 2: T // 2 + 5] = -100
    pos = np.broadcast_to(np.arange(T, dtype=np.float32), (B, 3, T)).copy()
    pos[:, 1:, 10:30] = rng.integers(0, 8, (2, 20))
    slots = np.stack([np.sort(rng.choice(T, n_vis, replace=False)) for _ in range(B)])
    slots[:, -2:] = T
    ve = (rng.standard_normal((B, n_vis, D)) * 0.5).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "positions": pos, "vis_embeds": ve,
            "vis_slots": slots.astype(np.int32)}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _port_loss_and_grads(model, batch, freeze_vision=True, **kw):
    params = tstep.trained_params(model, freeze_vision)
    loss, count = tstep.sft_loss(CFG, model, _to_torch(batch), **kw)
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    tree = to_jax_params(CFG, model, grads=True)
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), int(count), tree


@pytest.fixture(scope="module")
def frozen_route(weights):
    """JAX's loss and text gradients on the frozen-tower batch."""
    params, _ = weights
    batch = _text_batch(np.random.default_rng(1))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, count), grads = jax.jit(jax.value_and_grad(
        lambda tp: jstep.sft_loss(JCFG, {**params, "text": tp}, jb), has_aux=True))(params["text"])
    return batch, float(loss), int(count), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_sft_loss_and_text_grads_equal_jax(weights, frozen_route, remat):
    """vis_embeds + vis_slots (out-of-range slots dropped): the loss to 1e-5
    relative and each text gradient leaf to 1e-5 + 1e-4 max |leaf| of
    jax.grad's, whatever the remat (which changes memory, not values)."""
    batch, jl, jc, jg = frozen_route
    model = _port_model(weights[1])
    loss, count, tree = _port_loss_and_grads(model, batch, remat=remat)
    assert count == jc
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    _assert_trees_close(tree["text"], jg)


def test_remat_modes_give_equal_grads(weights):
    """"full" and "dots" recompute exactly what "none" keeps."""
    batch = _text_batch(np.random.default_rng(2), B=1, T=40, n_vis=4)
    model = _port_model(weights[1])
    ref = _port_loss_and_grads(model, batch, remat="none")
    for remat in ("full", "dots"):
        got = _port_loss_and_grads(model, batch, remat=remat)
        assert got[0] == ref[0]
        _assert_trees_close(got[2], ref[2], rel=0, atol=1e-6)


def test_sft_loss_pixel_patches_unfrozen_tower_equals_jax(weights):
    """pixel_patches + grid_thw runs the tower inside the loss; with
    freeze_vision=False every leaf's gradient, the tower's included, equals
    jax.grad's over the whole tree."""
    params, np_params = weights
    rng = np.random.default_rng(5)
    grid = (1, 4, 4)
    batch = _text_batch(rng, B=1, T=48, n_vis=4)
    del batch["vis_embeds"]
    batch["vis_slots"] = np.array([[3, 4, 5, 6]], np.int32)
    pd = 3 * 2 * 14 * 14
    batch["pixel_patches"] = rng.standard_normal((1, 16, pd)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.sft_loss(JCFG, p, jb, grid_thw=grid), has_aux=True))(params)
    model = _port_model(np_params)
    loss, _, tree = _port_loss_and_grads(model, batch, freeze_vision=False, grid_thw=grid)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    _assert_trees_close(tree, jax.tree_util.tree_map(np.asarray, jg))


def test_tied_head_gradient_reaches_embed():
    """A tied model's head is its embedding matrix: fused_linear_ce's weight
    gradient and the embedding lookup's meet in one leaf, equal to JAX's
    (the JAX head is embed.T)."""
    rng = np.random.default_rng(9)
    V, D, T = 53, 16, 40
    emb = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    ids = rng.integers(0, V, T)
    tgt = rng.integers(0, V, T - 1).astype(np.int32)
    m = rng.random(T - 1) > 0.3

    def jloss(e):
        h = jnp.tanh(e[ids])[:-1]
        return jstep.fused_linear_ce(h, e.T, jnp.asarray(tgt), jnp.asarray(m))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_()
    loss = tstep.fused_linear_ce(torch.tanh(e[torch.from_numpy(ids)])[:-1], e,
                                 torch.from_numpy(tgt).long(), torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jg), atol=1e-5)


# ---------------------------------------------------------------- the optimizer


def _grad_stream(rng, shapes, n):
    """n gradient sets; the third is large enough to be clipped."""
    out = []
    for i in range(n):
        scale = 5.0 if i == 2 else 0.05
        out.append([(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes])
    return out


@pytest.mark.parametrize("every_k", [1, 2], ids=["adamw", "multisteps2"])
def test_optimizer_equals_optax(every_k):
    """make_optimizer (+ MultiSteps) against optax's chain on identical
    gradients over 5 micro-steps (at every_k 2: boundaries at 2 and 4): lr 0
    at count 0, a clipped update, weight decay; parameters within 1e-6
    relative after every micro-step."""
    rng = np.random.default_rng(8)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = _grad_stream(rng, shapes, 5)
    kw = dict(learning_rate=0.05, weight_decay=0.1, grad_clip=1.0, warmup_steps=2,
              total_steps=6)
    jopt = optax.MultiSteps(jstep.make_optimizer(**kw), every_k)
    jp = [jnp.asarray(p) for p in p0]
    js = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    topt = tstep.MultiSteps(tstep.make_optimizer(**kw), every_k)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ts = topt.init(tp)
    clipped = 0
    for g in grads:
        clipped += float(optax.global_norm([jnp.asarray(x) for x in g])) >= 1.0
        ju, js = jupdate([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update([torch.from_numpy(x) for x in g], ts, tp)
        tstep.apply_updates(tp, tu)
        for a, b in zip(tp, jp):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    assert clipped == 1
    assert ts["inner"]["count"] == int(js.inner_opt_state[1][0].count) == 5 // every_k
    # the first boundary's update used lr 0: the parameters had not moved
    assert tstep.warmup_cosine_lr(0, 0.05, 2, 6) == 0.0


def test_schedule_equals_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 12)
    for c in range(15):
        np.testing.assert_allclose(tstep.warmup_cosine_lr(c, 3e-4, 4, 12), float(sched(c)),
                                   rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------- the trainer


@pytest.fixture(scope="module")
def annotation(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_data")
    vid = str(d / "clip.mp4")
    jingest.build_native()
    jingest.write_test_video(vid, w=56, h=56, n_frames=30, fps=10)
    ts = [[0.0, 0.4, "hello"], [0.5, 0.9, "world"], [1.0, 1.4, "this"], [1.5, 1.9, "is"],
          [2.0, 2.4, "a"], [2.5, 2.9, "test"]]
    conv = [
        {"role": "user", "content": [{"type": "video", "video": vid, "video_start": 0.0,
                                      "video_end": 3.0, "previous": "earlier words"}]},
        {"role": "assistant", "content": [{"type": "text", "text_stream": ts,
                                           "qa_stream": [[1.0, 2.0, " What?", "A gradient."]]}]},
    ]
    ann = str(d / "train.jsonl")
    with open(ann, "w") as f:
        f.write(json.dumps(conv) + "\n")
        conv[0]["content"][0]["previous"] = ""
        f.write(json.dumps(conv) + "\n")
    return ann


PIX = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=4 * 28 * 28)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, max_steps=2, grad_accum=2, save_steps=1,
             seq_buckets=(256,), vis_buckets=(16,), remat="none")  # remat: its own tests


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_run(annotation, weights, tmp_path_factory):
    """The JAX Trainer, 4 micro-steps at grad_accum 2."""
    out = str(tmp_path_factory.mktemp("jax_run"))
    ds = JDataset([annotation], cfg=JCFG, encode=JFakeTokenizer(JCFG.tokens), video=JVideo(**PIX))
    tr = jtrainer.Trainer(JCFG, weights[0], jtrainer.TrainConfig(output_dir=out, **TRAIN))
    final = tr.train(ds, resume=False)
    return _rows(out), jax.tree_util.tree_map(np.asarray, final)


def _port_run(annotation, np_params, out, **kw):
    ds = StreamDataset([annotation], cfg=CFG, encode=FakeTokenizer(CFG.tokens),
                       video=VideoConfig(**PIX))
    model = _port_model(np_params)
    tr = ttrainer.Trainer(CFG, model, ttrainer.TrainConfig(output_dir=out, **{**TRAIN, **kw}))
    return tr, ds


def test_trainer_equals_jax_trainer_and_resumes(annotation, weights, jax_run, tmp_path):
    """Same metrics rows (step, opt_step, labeled tokens; loss to 1e-5,
    grad_norm to 1e-4) and final weights (to 1e-5, 1% of lr) as the JAX
    Trainer; checkpoints at the optimizer boundaries only; a fresh Trainer
    resumed from checkpoint-2 without prefetch (the straight run fetched 2
    ahead) ends bit for bit where the straight run ended, with the straight
    run's losses."""
    jrows, jfinal = jax_run
    straight = str(tmp_path / "straight")
    tr, ds = _port_run(annotation, weights[1], straight)
    tr.train(ds, resume=False)
    rows = _rows(straight)
    assert tr.step == 4 and len(rows) == len(jrows) == 4
    for r, j in zip(rows, jrows):
        assert (r["step"], r["opt_step"], r["labeled_tokens"]) == \
            (j["step"], j["opt_step"], j["labeled_tokens"])
        np.testing.assert_allclose(r["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], j["grad_norm"], rtol=1e-4)
    # Adam divides by sqrt(nu): where a gradient is near zero it turns 1e-7
    # differences of the gradients into a visible part of lr (1e-3)
    _assert_trees_close(to_jax_params(CFG, tr.model), jfinal, rel=0, atol=1e-5)
    assert sorted(os.listdir(straight)) == ["checkpoint-2", "checkpoint-4", "metrics.jsonl"]
    assert ttrainer.find_resume_checkpoint(straight).endswith("checkpoint-4")

    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    os.rename(os.path.join(straight, "checkpoint-2"), os.path.join(resumed, "checkpoint-2"))
    tr2, _ = _port_run(annotation, weights[1], resumed, prefetch=0)
    tr2.train(ds, resume=True)
    assert tr2.step == 4
    assert [r["loss"] for r in _rows(resumed)] == [r["loss"] for r in rows[2:]]
    want = dict(tr.model.state_dict())
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_trainer_refuses_the_unported_mesh_modes(weights, tmp_path):
    model = _port_model(weights[1])
    for kw in (dict(parallel_mode="pp"), dict(parallel_mode="sp")):
        with pytest.raises(ValueError, match="queue 1 item 5"):
            ttrainer.Trainer(CFG, model, ttrainer.TrainConfig(output_dir=str(tmp_path), **kw))
    with pytest.raises(ValueError, match="queue 1 item 5"):
        ttrainer.Trainer(CFG, model, ttrainer.TrainConfig(output_dir=str(tmp_path)), mesh=object())
