"""Functions that the ranks of a `_torch_world.World` run for the port's
parallel tests (tests/test_torch_parallel_*.py). Torch and the port only:
the JAX references run in the pytest process. Each takes the weights as
the JAX tree of numpy arrays (models/bridge.from_jax_params builds the
port's model on every rank) and returns numpy results that the test
compares across ranks and with JAX."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from streaming_vlm_tpu_torch.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.parallel.mesh import make_mesh
from streaming_vlm_tpu_torch.streaming import protocol as P

CFG = qwen25_vl_tiny()
GRID = (1, 4, 4)
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
GREEDY = SamplingConfig(do_sample=False)


def parity_stream(**kw) -> StreamConfig:
    """tests/test_mesh.py's stream: rounds of 2, a 4 + 3 previous-text
    sink / window (evictions within 4 chunks)."""
    base = dict(text_round=2, window_size=2, chunk_duration=1, text_sink=4,
                text_sliding_window=3, max_tokens_per_chunk=4, kv_capacity=1024,
                prefill_buckets=(64, 128, 256))
    base.update(kw)
    return StreamConfig(**base)


def chunk_segs(b, i: int):
    n_vid = GRID[0] * (GRID[1] // 2) * (GRID[2] // 2)
    out = []
    if i == 0:
        out.append(b.system_segment())
        out.extend(b.previous_text_segments("hello"))
        out.extend(b.user_turn_segments(0, 0.0, 1.0, n_vid, GRID, 1.0, query="q"))
    else:
        out.extend(b.user_turn_segments(i, float(i), float(i + 1), n_vid, GRID, 1.0))
    return out + b.assistant_open_segments(i)


def chunk_pixels(n_chunks: int):
    rng = np.random.default_rng(3)
    return [(rng.normal(size=(int(np.prod(GRID)), PATCH_DIM)) * 0.1).astype(np.float32)
            for _ in range(n_chunks)]


def _member(mesh_shape):
    mesh = make_mesh(mesh_shape)
    return mesh if mesh.member else None


def drive_engine(tree, mesh_shape, stream_kw, n_chunks=4, dtype="float32", quantize=None):
    """The tiny engine over n_chunks of tests/test_mesh.py's stream on a mesh
    (None: one rank, no mesh). Returns per chunk (tokens, table ids, cached,
    uncached_tail, positions, first logits of chunk 0)."""
    from streaming_vlm_tpu_torch.ops.quant import quantize_model
    from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

    mesh = _member(mesh_shape) if mesh_shape else None
    if mesh_shape and mesh is None:
        return None
    dt = getattr(torch, dtype)
    model = from_jax_params(CFG, tree, device="cpu", dtype=dt)
    if quantize:
        quantize_model(model, bits=quantize)
    eng = StreamingEngine(CFG, model, parity_stream(**stream_kw), GREEDY, dtype=dt, mesh=mesh)
    b = P.PromptBuilder(CFG.tokens, P.FakeTokenizer(CFG.tokens))
    _, end_bias = b.measure_biases()
    out = []
    for i, px in enumerate(chunk_pixels(n_chunks)):
        g, _ = eng.process_chunk(chunk_segs(b, i), px, GRID)
        eng.commit_assistant(g, end_bias, i)
        out.append((np.asarray(g), eng.table.token_ids().copy(), eng.cached, eng.uncached_tail,
                    eng._positions().copy(), eng.cached_after_evict < eng.cached_before_evict))
    return out


def chunk0_logits(tree, mesh_shape, quantize=None, dtype="float32"):
    """The logits of chunk 0's prefill (the last real token's), through the
    engine's own prefill path (`prefill_lanes`), on a mesh or one rank."""
    from streaming_vlm_tpu_torch.ops.quant import quantize_model
    from streaming_vlm_tpu_torch.streaming import engine as E

    mesh = _member(mesh_shape) if mesh_shape else None
    if mesh_shape and mesh is None:
        return None
    dt = getattr(torch, dtype)
    model = from_jax_params(CFG, tree, device="cpu", dtype=dt)
    if quantize:
        quantize_model(model, bits=quantize)
    eng = E.StreamingEngine(CFG, model, parity_stream(kv_quant="int8"), GREEDY, dtype=dt,
                            mesh=mesh)
    got = {}
    real = E.language.lm_logits

    def spy(cfg, lm, hidden):
        logits = real(cfg, lm, hidden)
        got.setdefault("logits", logits.detach().clone())
        return logits

    E.language.lm_logits = spy
    try:
        b = P.PromptBuilder(CFG.tokens, P.FakeTokenizer(CFG.tokens))
        eng.process_chunk(chunk_segs(b, 0), chunk_pixels(1)[0], GRID)
    finally:
        E.language.lm_logits = real
    return got["logits"].float().numpy()


def w8a8_products(mesh_shape, seed=0):
    """Each W8A8 product of the TP split against the unsharded qdot_plain:
    row-parallel (MAX-reduced absmax, K5's int32 partials summed, then the
    rescale) bitwise equal; column-parallel bitwise equal to its columns.
    Returns the number of products checked."""
    from streaming_vlm_tpu_torch.ops.quant import QLinear, qdot_plain, quantize_weight
    from streaming_vlm_tpu_torch.parallel.tp import _shard_linear
    from streaming_vlm_tpu_torch.parallel.mesh import P as Spec

    mesh = _member(mesh_shape)
    if mesh is None:
        return None
    tp, r, g = mesh.size("model"), mesh.index("model"), mesh.group("model")
    rng = np.random.default_rng(seed)
    n = 0
    for M, K, N, bias in ((1, 64, 96, True), (7, 128, 64, False), (40, 384, 32, True),
                          (3, 36, 48, True)):  # 18 columns a rank: padded to 20
        w = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.05)
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
        lin = QLinear(K, N, bias)
        lin.q, lin.s = quantize_weight(w)
        if bias:
            lin.bias.data.copy_(torch.from_numpy(rng.normal(size=N).astype(np.float32)))
        full = qdot_plain(x, lin.q, lin.s, lin.bias)
        row = _shard_linear(lin, Spec("model", None), None, "", tp, r, g, None)
        got = row(x.chunk(tp, dim=1)[r].contiguous())
        assert torch.equal(got, full), ("row", M, K, N)
        col = _shard_linear(lin, Spec(None, "model"), Spec("model"), "", tp, r, g, None)
        assert torch.equal(col(x), full.chunk(tp, dim=1)[r]), ("col", M, K, N)
        n += 2
    return n


def refusals(tree):
    """The refusals that stay true under a mesh, as (what, message)."""
    from streaming_vlm_tpu_torch.ops.quant import QLinear4
    from streaming_vlm_tpu_torch.parallel.tp import _shard_linear
    from streaming_vlm_tpu_torch.parallel.mesh import P as Spec
    from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

    out = []
    mesh = make_mesh({"model": 2})
    if not mesh.member:
        return None
    # a 'model' axis that does not divide the heads: 3 query heads
    cfg3 = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, num_attention_heads=6,
                                                              num_key_value_heads=3))
    model = from_jax_params(CFG, tree, device="cpu")
    try:
        StreamingEngine(cfg3, model, parity_stream(), GREEDY, dtype=torch.float32, mesh=mesh)
    except ValueError as e:
        out.append(("heads", str(e)))
    # W4A8 scale groups that would straddle the split: in 128 = one group
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 128)).astype(np.float32))
    lin4 = QLinear4.from_weight(w)
    try:
        _shard_linear(lin4, Spec("model", None), None, "", 2, mesh.index("model"),
                      mesh.group("model"), None)
    except ValueError as e:
        out.append(("int4", str(e)))
    # spec decode under a mesh
    eng = StreamingEngine(CFG, from_jax_params(CFG, tree, device="cpu"), parity_stream(),
                          GREEDY, dtype=torch.float32, mesh=mesh)
    b = P.PromptBuilder(CFG.tokens, P.FakeTokenizer(CFG.tokens))
    try:
        eng.process_chunk_spec(chunk_segs(b, 0), chunk_pixels(1)[0], GRID)
    except ValueError as e:
        out.append(("spec", str(e)))
    return out


def mesh_shapes():
    """The mesh builders' shapes, axis order and this rank's coordinates."""
    from streaming_vlm_tpu_torch.parallel.distributed import (
        batch_spec, make_multislice_mesh, make_slice_mesh)

    n = dist.get_world_size()
    a = make_slice_mesh(model_parallel=2)
    b = make_multislice_mesh(num_slices=2, model_parallel=n // 4) if n >= 4 else None
    c = make_mesh({"data": 2, "model": n // 2})
    return {
        "slice": (a.shape, a.coords, batch_spec(a)),
        "multislice": None if b is None else (b.shape, b.coords, batch_spec(b)),
        "mesh": (c.shape, c.coords, c.ranks("data"), c.ranks("model"), c.ranks(("data", "model"))),
        "rank": dist.get_rank(),
    }


# ---------------------------------------------------------------------------
# Training: ring attention (sp), pipeline (pp), the Trainer
# ---------------------------------------------------------------------------


def text_grads(model, first_layer: int = 0) -> dict:
    """The port's text gradients in the JAX layout, one entry per leaf and
    layer: ("q_w", i) -> [in, out], ("embed",) -> [V, D], ... (a pipeline
    stage's layers numbered from first_layer)."""
    from streaming_vlm_tpu_torch.models.bridge import _TEXT_LAYER

    def arr(p):
        return (torch.zeros_like(p) if p.grad is None else p.grad).detach().float().numpy()

    lm = model.text
    out = {("embed",): arr(lm.embed.weight), ("final_ln",): arr(lm.final_ln.weight)}
    if lm.lm_head is not None:
        out[("lm_head",)] = arr(lm.lm_head.weight).T
    for j, layer in enumerate(lm.layers):
        i = first_layer + j
        out[("input_ln", i)] = arr(layer.input_ln.weight)
        out[("post_ln", i)] = arr(layer.post_ln.weight)
        for attr, (wk, bk) in _TEXT_LAYER.items():
            mod = getattr(layer, attr)
            out[(wk, i)] = arr(mod.weight).T
            if bk is not None:
                out[(bk, i)] = arr(mod.bias)
    return out


def _batch_t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        p.grad = g


def train_loss(tree, mode, mesh_shape, batch, remat="none"):
    """sft_loss (mode None, one rank), sft_loss_sp or sft_loss_pp on the
    mesh: (loss, count, text gradients in the JAX layout)."""
    from streaming_vlm_tpu_torch.parallel.pipeline import sft_loss_pp, split_stages
    from streaming_vlm_tpu_torch.parallel.ring import sft_loss_sp
    from streaming_vlm_tpu_torch.train.step import sft_loss, trained_params

    mesh = _member(mesh_shape) if mesh_shape else None
    if mesh_shape and mesh is None:
        return None
    model = from_jax_params(CFG, tree, device="cpu")
    first = 0
    if mode == "pp":
        first = split_stages(CFG, model, mesh)[0]
    params = trained_params(model)
    bt = _batch_t(batch)
    if mode == "sp":
        loss, count = sft_loss_sp(CFG, model, bt, mesh, remat=remat)
    elif mode == "pp":
        loss, count = sft_loss_pp(CFG, model, bt, mesh, remat=remat)
    else:
        loss, count = sft_loss(CFG, model, bt, remat=remat)
    _set_grads(params, torch.autograd.grad(loss, params))
    return float(loss.detach()), int(count), text_grads(model, first)


def sp_forward(tree, mesh_shape, x, pos):
    """sp_language_forward's hidden states [B, T, D]."""
    from streaming_vlm_tpu_torch.parallel.ring import sp_language_forward

    mesh = _member(mesh_shape)
    if mesh is None:
        return None
    model = from_jax_params(CFG, tree, device="cpu")
    with torch.no_grad():
        h = sp_language_forward(CFG.text, model.text, torch.from_numpy(x), torch.from_numpy(pos),
                                mesh)
    return h.numpy()


def pp_forward(tree, mesh_shape, x, pos, remat="none"):
    """pipeline_language_forward's [M, T, D] pre-final-norm hidden states."""
    from streaming_vlm_tpu_torch.parallel.pipeline import pipeline_language_forward, split_stages

    mesh = _member(mesh_shape)
    if mesh is None:
        return None
    model = from_jax_params(CFG, tree, device="cpu")
    split_stages(CFG, model, mesh)
    with torch.no_grad():
        h = pipeline_language_forward(CFG.text, model.text.layers, torch.from_numpy(x),
                                      torch.from_numpy(pos), mesh, remat=remat)
    return h.numpy()


def trainer_step(tree, mode, mesh_shape, batch, tmp_dir, remat="none"):
    """One Trainer step (TrainConfig as tests/test_pipeline.py's trainer
    test) in `mode` on the mesh (None: one rank): its metrics, and the
    replicated text parameters after the step (embed, final_ln, lm_head),
    which every rank must hold equal; with gspmd, also the moments' bytes."""
    from streaming_vlm_tpu_torch.train import trainer as T

    mesh = _member(mesh_shape) if mesh_shape else None
    if mesh_shape and mesh is None:
        return None
    model = from_jax_params(CFG, tree, device="cpu")
    if mode == "pp-step":  # parallel/pipeline.make_train_step_pp with the Trainer's optimizer
        from streaming_vlm_tpu_torch.parallel.pipeline import make_train_step_pp, split_stages
        from streaming_vlm_tpu_torch.train import step as S

        split_stages(CFG, model, mesh)
        opt = S.MultiSteps(S.make_optimizer(warmup_steps=1, total_steps=2), 1)
        state = opt.init(S.trained_params(model))
        _, m = make_train_step_pp(CFG, opt, mesh, remat=remat)(model, state, _batch_t(batch))
        lm = model.text
        return ({k: float(v) for k, v in m.items()},
                {"final_ln": lm.final_ln.weight.detach().numpy().copy()}, 0)
    tc = T.TrainConfig(output_dir=f"{tmp_dir}/{mode}-{dist.get_rank() if dist.is_initialized() else 0}",
                       max_steps=2, warmup_steps=1, grad_accum=1, remat=remat, parallel_mode=mode)
    tr = T.Trainer(CFG, model, tc, mesh=mesh)
    m = tr._train_step(_batch_t(batch))
    lm = model.text
    rep = {"final_ln": lm.final_ln.weight.detach().numpy().copy()}
    if mode != "gspmd" or mesh is None:
        rep["embed"] = lm.embed.weight.detach().numpy().copy()
        rep["lm_head"] = lm.lm_head.weight.detach().numpy().copy()
    inner = tr.opt_state["inner"]
    moments = sum(t.numel() * t.element_size() for t in inner["mu"] + inner["nu"])
    return ({k: float(v) for k, v in m.items()}, rep, moments)


def round_embeds(n_lanes: int, n_rounds: int):
    """Each round's vision embeddings [B, n_vid, D] (one GRID a lane)."""
    rng = np.random.default_rng(7)
    n_vid = GRID[0] * (GRID[1] // 2) * (GRID[2] // 2)
    return [(rng.normal(size=(n_lanes, n_vid, CFG.text.hidden_size)) * 0.1).astype(np.float32)
            for _ in range(n_rounds)]


def drive_multistream(tree, mesh_shape, n_lanes, n_rounds, stream_kw=None):
    """MultiStreamEngine over n_rounds greedy rounds on a mesh (None: one
    rank): per round per lane (tokens, table ids, cached, uncached_tail,
    positions), and the lanes this rank ran."""
    from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine

    mesh = _member(mesh_shape) if mesh_shape else None
    if mesh_shape and mesh is None:
        return None
    model = from_jax_params(CFG, tree, device="cpu")
    ms = MultiStreamEngine(CFG, model, parity_stream(**(stream_kw or {})), GREEDY,
                           n_streams=n_lanes, dtype=torch.float32, mesh=mesh)
    bs = [P.PromptBuilder(CFG.tokens, P.FakeTokenizer(CFG.tokens)) for _ in range(n_lanes)]
    _, end_bias = bs[0].measure_biases()
    out = []
    for i, ve in enumerate(round_embeds(n_lanes, n_rounds)):
        res = ms.process_round([chunk_segs(b, i) for b in bs], vis_embeds=torch.from_numpy(ve),
                               grid_thw=GRID)
        ms.commit_assistant([g for g, _ in res], end_bias, i)
        out.append([(np.asarray(g), e.table.token_ids().copy(), e.cached, e.uncached_tail,
                     e._positions().copy()) for (g, _), e in zip(res, ms.engines)])
    return out, (ms.lo, ms.hi)


def lane_pixels(lane: int, n_chunks: int):
    """Each lane's own patches, chunk by chunk (seeded by the lane)."""
    rng = np.random.default_rng(30 + lane)
    return [(rng.normal(size=(int(np.prod(GRID)), PATCH_DIM)) * 0.1).astype(np.float32)
            for _ in range(n_chunks)]


def _late(rank: int, late: float, lane: int) -> None:
    """Ranks other than 0 reach lane `lane`'s attach `late` * (lane + 1) s
    after rank 0, so that rank 0 schedules that lane's chunks first."""
    import time

    if rank:
        time.sleep(late * (lane + 1))


def drive_server(tree, mesh_shape, n_lanes, n_chunks, late=0.0):
    """MultiStreamServer over MultiStreamEngine(mesh=), as the demo runs it:
    the round loop on its background thread, started before any client, and
    one feeder thread a lane that attaches with its lane as key, then submits
    n_chunks chunks one at a time, reading each result before the next.
    Ranks other than 0 attach late (`_late`). Per lane, each chunk's
    tokens."""
    import threading

    from streaming_vlm_tpu_torch.streaming.multiserve import MultiStreamServer
    from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine

    mesh = _member(mesh_shape)
    model = from_jax_params(CFG, tree, device="cpu")
    ms = MultiStreamEngine(CFG, model, parity_stream(), GREEDY, n_streams=n_lanes,
                           dtype=torch.float32, mesh=mesh)
    _, end_bias = P.PromptBuilder(CFG.tokens, P.FakeTokenizer(CFG.tokens)).measure_biases()
    server = MultiStreamServer(ms, end_bias=end_bias)
    got = [[] for _ in range(n_lanes)]
    errors = []

    def feed(lane):
        try:
            _late(mesh.rank, late, lane)
            client = server.attach(seed=lane, key=lane)
            b = P.PromptBuilder(CFG.tokens, P.FakeTokenizer(CFG.tokens))
            for i, px in enumerate(lane_pixels(lane, n_chunks)):
                client.submit(chunk_segs(b, i), pixel_patches=px, grid_thw=GRID)
                idx, gen = client.get(timeout=120.0)
                assert idx == i
                got[lane].append(np.asarray(gen))
        except BaseException as exc:  # noqa: BLE001  (raised below, in the rank)
            errors.append(exc)

    server.start()
    threads = [threading.Thread(target=feed, args=(lane,)) for lane in range(n_lanes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.stop()
    if errors:
        raise errors[0]
    return got


def drive_multiapp(tree, mesh_shape, videos, stream_kw, video_kw, duration, late=0.0):
    """MultiLiveCaptionServer(mesh=) over `videos`, one lane each, greedy:
    each lane's caption segments; rank 0 also answers HTTP (its port), the
    others serve none. Ranks other than 0 attach late (`_late`)."""
    from streaming_vlm_tpu_torch.config import VideoConfig
    from streaming_vlm_tpu_torch.demo.multiapp import MultiLiveCaptionServer

    model = from_jax_params(CFG, tree, device="cpu")
    srv = MultiLiveCaptionServer(CFG, model, P.FakeTokenizer(CFG.tokens), videos,
                                 stream=StreamConfig(**stream_kw), sampling=GREEDY,
                                 video=VideoConfig(**video_kw), duration=duration, port=0,
                                 dtype=torch.float32, mesh=mesh_shape)
    rank = srv.engine.mesh.rank
    attach = srv.server.attach

    def late_attach(seed=None, snapshot=None, key=None):
        _late(rank, late, key)
        return attach(seed=seed, snapshot=snapshot, key=key)

    srv.server.attach = late_attach
    srv.start_background()
    try:
        done = srv.wait(timeout=180.0)
    finally:
        srv.shutdown()
    assert done, "a feeder did not finish"
    return [list(f.items) for f in srv.feeds], srv.port
