"""The port's sharding rules and placement (streaming_vlm_tpu_torch/parallel/
mesh.py), host logic held against the JAX package's parallel/mesh.py on
conftest's virtual CPU devices: `sharding_for_tree` leaf for leaf on the
tiny and the 7B-geometry trees (tests/test_mesh.py's), bf16, W8A8 and W4A8;
the port's module placement equal to the rules outside its listed
deviations (heads that the 'model' axis does not divide); `serving_rules`,
`arena_sharding(_tree)`, `arena_shard_factor` and `_lane_axis`."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from streaming_vlm_tpu.config import qwen25_vl_7b as j7b
from streaming_vlm_tpu.config import qwen25_vl_tiny as jtiny
from streaming_vlm_tpu.models.qwen25_vl import model as jmodel
from streaming_vlm_tpu.ops.quant import quantize_model_params
from streaming_vlm_tpu.parallel import mesh as jm
from streaming_vlm_tpu_torch.config import qwen25_vl_7b, qwen25_vl_tiny
from streaming_vlm_tpu_torch.models.qwen25_vl.model import Qwen25VL
from streaming_vlm_tpu_torch.ops.quant import QuantKV
from streaming_vlm_tpu_torch.parallel import mesh as tm

MESHES = ({"data": 2, "model": 4}, {"data": 1, "model": 2}, {"data": 4, "model": 2},
          {"data": 1, "model": 8})


def _7b_geometry(cfg):
    """tests/test_mesh.py's 7B geometry: 28 / 4 heads of 128, hidden 3584,
    at reduced depth, vocabulary and MLP."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=2, vocab_size=8192,
                                      intermediate_size=4736),
        vision=dataclasses.replace(cfg.vision, depth=2, fullatt_block_indexes=(1,),
                                   hidden_size=64, intermediate_size=128, num_heads=4,
                                   window_size=28, out_hidden_size=3584))


CFGS = {"tiny": (jtiny(), qwen25_vl_tiny()), "7b": (_7b_geometry(j7b()),
                                                  _7b_geometry(qwen25_vl_7b()))}


@pytest.fixture(scope="module")
def shape_trees():
    """The JAX parameter trees' shapes (jax.eval_shape): bf16, W8A8, W4A8."""
    out = {}
    for name, (jcfg, _) in CFGS.items():
        p = jax.eval_shape(lambda c=jcfg: jmodel.init_params(c, jax.random.PRNGKey(0)))
        out[name] = {"bf16": p, "w8a8": jax.eval_shape(quantize_model_params, p),
                     "w4a8": jax.eval_shape(lambda x: quantize_model_params(x, text_bits=4), p)}
    return out


def _jax_mesh(shape):
    return jm.make_mesh(shape)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("quant", ["bf16", "w8a8", "w4a8"])
def test_sharding_for_tree_equals_jax(shape_trees, cfg, quant):
    """Every leaf's spec (the rules, the /(q|s)$ strip, the divisibility
    fallback) equals JAX's on each mesh, for the text and vision rules and
    their serving variants."""
    tree = shape_trees[cfg][quant]
    for shape in MESHES:
        jmesh = _jax_mesh(shape)
        for part, rules in (("text", "TEXT_TP_RULES"), ("vision", "VISION_TP_RULES")):
            for serving in (False, True):
                jr, tr = getattr(jm, rules), getattr(tm, rules)
                if serving:
                    jr, tr = jm.serving_rules(jr), tm.serving_rules(tr)
                want = dict(_flat(jax.tree_util.tree_map(
                    lambda s: tuple(s.spec), jm.sharding_for_tree(tree[part], jmesh, jr),
                    is_leaf=lambda x: hasattr(x, "spec"))))
                got = dict(_flat(tm.sharding_for_tree(tree[part], shape, tr)))
                assert {k: tuple(v) for k, v in got.items()} == want, (shape, part, serving)


def _expected_deviations(cfg, shape):
    """The leaves whose heads the 'model' axis does not divide (replicated
    by the port, split mid-head by JAX where the columns divide)."""
    m, t, v = shape["model"], cfg.text, cfg.vision
    out = set()
    if t.num_attention_heads % m:
        out |= {"q_w", "q_b", "o_w"}
    if t.num_key_value_heads % m:
        out |= {"k_w", "k_b", "v_w", "v_b"}
    if v.num_heads % m:
        out |= {"qkv_w", "qkv_b", "proj_w"}
    return out


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("serving", [True, False], ids=["serving", "training"])
def test_placement_equals_the_rules_outside_the_deviations(shape_trees, cfg, serving):
    """`placement` (what parallel/tp.py cuts by): each linear's weight and
    bias spec equals JAX's spec of its leaf (the layer axis dropped), except
    the listed deviations, which it replicates on 'model'."""
    jcfg, pcfg = CFGS[cfg]
    with torch.device("meta"):
        model = Qwen25VL(pcfg)
    tree = shape_trees[cfg]["bf16"]
    for shape in MESHES:
        jmesh = _jax_mesh(shape)
        rules = {"text": jm.TEXT_TP_RULES, "vision": jm.VISION_TP_RULES}
        if serving:
            rules = {k: jm.serving_rules(r) for k, r in rules.items()}
        specs = {part: dict(_flat(jax.tree_util.tree_map(
            lambda s: tuple(s.spec), jm.sharding_for_tree(tree[part], jmesh, rules[part]),
            is_leaf=lambda x: hasattr(x, "spec")))) for part in rules}
        place = tm.placement(pcfg, model, shape, serving=serving)
        differ = set()
        for name, mod, w_path, b_path, heads in tm.linears(pcfg, model):
            part, leaf = w_path.split("/", 1)
            lead = 1 if ("/layers/" in w_path or "/blocks/" in w_path) else 0
            want_w = specs[part][leaf][lead:]
            got_w, got_b = place[name]
            pad = lambda s, n: tuple(s) + (None,) * (n - len(s))  # noqa: E731
            if pad(got_w, 2) != pad(want_w, 2):
                differ.add(w_path.rsplit("/", 1)[1])
                assert all(a != "model" for a in got_w), name  # replicated on 'model'
            if b_path is not None and got_b is not None:
                want_b = specs[part][b_path.split("/", 1)[1]][lead:]
                if pad(got_b, 1) != pad(want_b, 1):
                    differ.add(b_path.rsplit("/", 1)[1])
        assert tuple(place["text.embed"][0]) == tuple(specs["text"]["embed"])
        assert differ == _expected_deviations(pcfg, shape), (shape, differ)


def _kv_arena(batched, quant):
    shape = (2, 4, 16, 4, 8) if batched else (4, 16, 4, 8)
    if not quant:
        return np.zeros(shape, np.float32)
    return {"q": np.zeros(shape, np.int8), "s": np.zeros(shape[:-1], np.float32)}


def test_serving_host_logic_equals_jax():
    """serving_rules, arena_sharding, arena_sharding_tree (float and int8
    arenas; the port's QuantKV too), arena_shard_factor and _lane_axis equal
    JAX's over meshes, kv-head counts, the stacked form and lane counts."""
    for jr, tr in ((jm.TEXT_TP_RULES, tm.TEXT_TP_RULES), (jm.VISION_TP_RULES, tm.VISION_TP_RULES)):
        assert [(p, tuple(s)) for p, s in tm.serving_rules(tr)] == [
            (p, tuple(s)) for p, s in jm.serving_rules(jr)]
    for shape in MESHES + ({"data": 2, "model": 2}, {"data": 8, "model": 1}):
        jmesh = _jax_mesh(shape)
        for kv in (1, 2, 3, 4, 8):
            for lanes in (None, 1, 2, 4, 6, 8):
                assert tm._lane_axis(shape, lanes) == jm._lane_axis(jmesh, lanes)
                assert tm.arena_shard_factor(shape, kv, lanes=lanes) == jm.arena_shard_factor(
                    jmesh, kv, lanes=lanes)
                for batched in (False, True):
                    want = jm.arena_sharding(jmesh, kv, batched=batched, lanes=lanes).spec
                    assert tuple(tm.arena_sharding(shape, kv, batched=batched, lanes=lanes)) \
                        == tuple(want)
                    for quant in (False, True):
                        arena = _kv_arena(batched, quant)
                        w = jm.arena_sharding_tree(jmesh, kv, arena, batched=batched, lanes=lanes)
                        g = tm.arena_sharding_tree(shape, kv, arena, batched=batched, lanes=lanes)
                        if quant:
                            assert {k: tuple(v) for k, v in g.items()} == {
                                k: tuple(v.spec) for k, v in w.items()}
                            qkv = QuantKV(torch.zeros(1), torch.zeros(1))
                            g2 = tm.arena_sharding_tree(shape, kv, qkv, batched=batched,
                                                        lanes=lanes)
                            assert g2 == g
                        else:
                            assert tuple(g) == tuple(w.spec)
    assert tm.arena_shard_factor(None, 4) == jm.arena_shard_factor(None, 4) == 1
