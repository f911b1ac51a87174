"""Live-stream snapshot / restore: a mid-flight stream's whole state (the
valid KV-arena prefix, the segment table, positions, host accounting and
the sampling generator) as host numpy, so that a stream can be written to
disk, recovered after a fault, or moved between engines, processes and
cards, into or out of a multi-stream lane
(`MultiStreamEngine.snapshot_lane` / `restore_lane`).

Port of streaming_vlm_tpu/streaming/snapshot.py, with the same dict, the
same field names, the same .npz + JSON manifest and SNAPSHOT_VERSION, so a
file written by either package restores in the other. Restoring a snapshot
and continuing gives exactly the tokens the uninterrupted engine gives.

What is kept, and why it is enough:
  * arena slots [0, cached) of K, V and ids: slot i holds the KV of table
    token i, and slots past `cached` are scratch that the next chunk
    writes before it reads them. K is the raw (un-rotated) arena; the
    pre-rotated copy is rebuilt from it at every chunk, so it is not kept;
  * the segment table (kind, ids, round, grid per segment): all the
    eviction policy reads;
  * cached / uncached_tail / chunk_index / next_pos and `_pos_host[:, :cached]`;
  * "rng": the engine's `torch.Generator` state (`get_state()`, a uint8
    array; the JAX package keeps its PRNG key there). A snapshot whose
    "rng" is not such a state for the restoring engine's generator (a JAX
    snapshot's key, or a state of a generator on another device type) is
    refused by name when the engine samples; a greedy engine draws nothing,
    so it takes the snapshot and keeps its own generator.

The arena layout is the JAX package's ([L, C, Hkv, hd], int8 scales [L, C,
Hkv]). A float arena's prefix is kept as f32 (numpy has no bf16; the
JAX package's file format upcasts bf16 to f32 too) and cast back to the
arena's dtype on restore. Weights are not part of a snapshot.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops.quant import is_kv_quantized

SNAPSHOT_VERSION = 1


# ---------------------------------------------------------------------------
# arena prefix <-> numpy
# ---------------------------------------------------------------------------


def _slots_to_np(arena, n: int):
    """Slots [0, n) of an [L, C, ...] arena as host numpy in its
    representation: {"q" int8, "s" f32} for an int8 arena, f32 for a float
    one; always a copy (a CPU arena's .numpy() would share its memory)."""
    def host(t):
        return t.to("cpu", copy=True).numpy()

    if is_kv_quantized(arena):
        return {"q": host(arena.q[:, :n]), "s": host(arena.s[:, :n])}
    return host(arena[:, :n].float())


def _np_geometry(prefix):
    """(L, Hkv, hd) of a snapshotted arena prefix."""
    a = prefix["q"] if isinstance(prefix, dict) else prefix
    return a.shape[0], a.shape[2], a.shape[3]


def _write_slots(arena, prefix, n: int) -> None:
    """Set slots [0, n) of an [L, C, ...] arena (in place) from a snapshot
    prefix of the same representation; later slots are left as they are
    (scratch)."""
    if not n:
        return
    quant = is_kv_quantized(arena)
    if quant != isinstance(prefix, dict):
        raise ValueError("snapshot arena representation does not match the engine's")
    def host(a, dtype):
        return torch.from_numpy(np.array(a, dtype))  # a copy: file arrays are read-only

    if quant:
        arena.q[:, :n] = host(prefix["q"], np.int8).to(arena.q.device)
        arena.s[:, :n] = host(prefix["s"], np.float32).to(arena.s.device)
    else:
        arena[:, :n] = host(prefix, np.float32).to(arena.device, arena.dtype)


def check_geometry(cfg, snap: Dict[str, Any]) -> None:
    """Raise ValueError unless the snapshot's arena prefix has the model's
    (layers, kv heads, head_dim)."""
    t = cfg.text
    geo = (t.num_hidden_layers, t.num_key_value_heads, t.head_dim)
    if int(snap["cached"]) and _np_geometry(snap["k"]) != geo:
        raise ValueError(f"snapshot arena geometry {_np_geometry(snap['k'])} (layers, kv heads, "
                         f"head_dim) != the model's {geo}")


# ---------------------------------------------------------------------------
# the sampling generator
# ---------------------------------------------------------------------------


def generator_state(generator: torch.Generator) -> np.ndarray:
    """A generator's state as the snapshot's "rng" (uint8)."""
    return generator.get_state().numpy().copy()


def takes_rng(snap: Dict[str, Any], generator: torch.Generator) -> bool:
    """True when the snapshot's "rng" is a state of a generator like this
    one (uint8, the same length)."""
    rng = np.asarray(snap["rng"])
    return rng.dtype == np.uint8 and rng.shape == tuple(generator.get_state().shape)


def check_rng(snap: Dict[str, Any], generator: torch.Generator, do_sample: bool) -> None:
    """Raise ValueError, naming "rng", when a sampling engine would restore a
    snapshot whose "rng" its generator cannot take (a greedy one draws
    nothing and may)."""
    if do_sample and not takes_rng(snap, generator):
        rng = np.asarray(snap["rng"])
        raise ValueError(
            f"snapshot field 'rng' ({rng.dtype}{list(rng.shape)}) is not a state of this "
            f"engine's torch.Generator ({generator.device.type}, uint8"
            f"{list(generator.get_state().shape)}); a sampling stream cannot continue "
            f"exactly without it (a greedy one can)")


def restore_rng(snap: Dict[str, Any], generator: torch.Generator, do_sample: bool) -> None:
    """Set the generator from the snapshot's "rng" where it takes it (see
    check_rng)."""
    check_rng(snap, generator, do_sample)
    if takes_rng(snap, generator):
        generator.set_state(torch.from_numpy(np.array(snap["rng"], np.uint8)))


# ---------------------------------------------------------------------------
# engine <-> snapshot dict
# ---------------------------------------------------------------------------


def snapshot_host(engine) -> Dict[str, Any]:
    """Host-side state of a StreamingEngine (everything but the arena; "rng"
    is its own generator's state, which a multi-stream lane replaces)."""
    assert engine._inflight is None, "snapshot with a chunk in flight"
    return {
        "version": SNAPSHOT_VERSION,
        "kv_quant": engine.stream.kv_quant,
        "pos_mode": engine.stream.pos_mode,
        "all_text": engine.table.all_text,
        "cached": int(engine.cached),
        "uncached_tail": int(engine.uncached_tail),
        "chunk_index": int(engine.chunk_index),
        "next_pos": float(engine._next_pos),
        "rng": generator_state(engine.generator),
        "pos": engine._pos_host[:, : engine.cached].copy(),
        "table": [
            {
                "kind": s.kind,
                "ids": np.asarray(s.ids, np.int32),
                "round": int(s.round),
                "grid_thw": (tuple(int(x) for x in s.grid_thw)
                             if s.grid_thw is not None else None),
                "second_per_grid_t": float(s.second_per_grid_t),
            }
            for s in engine.table.segs
        ],
    }


def validate_snapshot(snap: Dict[str, Any], stream) -> None:
    """Check that a snapshot restores onto an engine built from `stream`
    (StreamConfig) without touching any engine. Raises ValueError naming
    the mismatch. Used by restore_host, and by serving front-ends at
    admission, so that a bad snapshot is refused in the caller's thread and
    not inside a batched round (multiserve.MultiStreamServer.attach)."""
    for key in ("version", "kv_quant", "pos_mode", "cached", "uncached_tail",
                "table", "rng", "pos", "chunk_index", "next_pos", "all_text"):
        if key not in snap:
            raise ValueError(f"snapshot is missing field {key!r}")
    if snap["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {snap['version']!r} != {SNAPSHOT_VERSION!r}")
    if stream.kv_quant != snap["kv_quant"]:
        raise ValueError(f"snapshot arena is kv_quant={snap['kv_quant']!r}, engine is "
                         f"{stream.kv_quant!r}")
    if stream.pos_mode != snap["pos_mode"]:
        raise ValueError(f"snapshot positions are pos_mode={snap['pos_mode']!r}, engine is "
                         f"{stream.pos_mode!r}")
    n = int(snap["cached"])
    if n > stream.kv_capacity:
        raise ValueError(f"snapshot holds {n} cached slots; engine kv_capacity="
                         f"{stream.kv_capacity} cannot hold them")
    total = sum(len(d["ids"]) for d in snap["table"])
    if total != n + int(snap["uncached_tail"]):
        raise ValueError(f"snapshot table holds {total} tokens but cached+uncached_tail="
                         f"{n + int(snap['uncached_tail'])}")


def restore_host(engine, snap: Dict[str, Any]) -> None:
    """Set a (fresh) StreamingEngine's host state from a snapshot: table,
    accounting, positions (and its own generator, as check_rng allows). The
    stream configs must agree on kv_quant and pos_mode; kv_capacity may
    differ (>= cached)."""
    from .segments import Seg, SegmentTable

    assert engine._inflight is None
    validate_snapshot(snap, engine.stream)
    check_geometry(engine.cfg, snap)
    restore_rng(snap, engine.generator, engine.sampling.do_sample)
    n = int(snap["cached"])
    table = SegmentTable(all_text=bool(snap["all_text"]))
    for d in snap["table"]:
        table.segs.append(Seg(
            kind=d["kind"],
            ids=np.asarray(d["ids"], np.int32),
            round=int(d["round"]),
            grid_thw=tuple(d["grid_thw"]) if d["grid_thw"] is not None else None,
            second_per_grid_t=float(d["second_per_grid_t"]),
        ))
    engine.table = table
    engine.cached = n
    engine.uncached_tail = int(snap["uncached_tail"])
    engine.chunk_index = int(snap["chunk_index"])
    engine._next_pos = float(snap["next_pos"])
    engine._pos_host = np.zeros((3, engine.stream.kv_capacity), np.float32)
    engine._pos_host[:, :n] = snap["pos"]


def restore_arena(k_arena, v_arena, ids_arena: torch.Tensor, snap: Dict[str, Any]) -> None:
    """Write a snapshot's slots [0, cached) into one stream's arenas ([L, C,
    ...] K and V, ids [C]) in place."""
    n = int(snap["cached"])
    ids_arena.zero_()
    if n:
        ids_arena[:n] = torch.from_numpy(np.asarray(snap["ids"], np.int64)).to(ids_arena.device)
    _write_slots(k_arena, snap["k"], n)
    _write_slots(v_arena, snap["v"], n)


def snapshot_arena(snap: Dict[str, Any], k_arena, v_arena, ids_arena: torch.Tensor) -> None:
    """Add one stream's arena prefix (slots [0, snap["cached"])) to a
    snapshot dict: "ids" (int32), "k", "v"."""
    n = int(snap["cached"])
    snap["ids"] = ids_arena[:n].cpu().numpy().astype(np.int32)
    snap["k"] = _slots_to_np(k_arena, n)
    snap["v"] = _slots_to_np(v_arena, n)


# ---------------------------------------------------------------------------
# file round trip (npz + json manifest; no pickle)
# ---------------------------------------------------------------------------


def save_snapshot(snap: Dict[str, Any], path: str) -> None:
    """Write a snapshot to one .npz (float arenas as f32, int8 ones as {q,
    s}), the JAX package's format."""
    arrays: Dict[str, np.ndarray] = {
        "rng": np.asarray(snap["rng"]),
        "ids": np.asarray(snap["ids"], np.int32),
        "pos": np.asarray(snap["pos"], np.float32),
    }

    def put_arena(name, a):
        if isinstance(a, dict):
            arrays[f"{name}_q"] = np.asarray(a["q"], np.int8)
            arrays[f"{name}_s"] = np.asarray(a["s"], np.float32)
        else:
            arrays[name] = np.asarray(a, np.float32)

    put_arena("k", snap["k"])
    put_arena("v", snap["v"])
    seg_ids = (np.concatenate([d["ids"] for d in snap["table"]]) if snap["table"]
               else np.zeros(0, np.int32))
    arrays["seg_ids"] = seg_ids.astype(np.int32)
    manifest = {k: snap[k] for k in ("version", "kv_quant", "pos_mode", "all_text", "cached",
                                     "uncached_tail", "chunk_index", "next_pos")}
    manifest["segs"] = [
        {
            "kind": d["kind"],
            "len": int(len(d["ids"])),
            "round": d["round"],
            "grid_thw": list(d["grid_thw"]) if d["grid_thw"] is not None else None,
            "second_per_grid_t": d["second_per_grid_t"],
        }
        for d in snap["table"]
    ]
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_snapshot(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        snap: Dict[str, Any] = dict(manifest)
        snap.pop("segs")
        snap["rng"] = z["rng"]
        snap["ids"] = z["ids"]
        snap["pos"] = z["pos"]
        for name in ("k", "v"):
            if f"{name}_q" in z:
                snap[name] = {"q": z[f"{name}_q"], "s": z[f"{name}_s"]}
            else:
                snap[name] = z[name]
        table: List[Dict[str, Any]] = []
        off = 0
        for d in manifest["segs"]:
            table.append({
                "kind": d["kind"],
                "ids": z["seg_ids"][off: off + d["len"]],
                "round": d["round"],
                "grid_thw": tuple(d["grid_thw"]) if d["grid_thw"] is not None else None,
                "second_per_grid_t": d["second_per_grid_t"],
            })
            off += d["len"]
        snap["table"] = table
    return snap

