"""Process-group set-up, the named-axis mesh and the collectives the port calls.

Port of streaming_vlm_tpu/parallel/distributed.py. JAX's mesh is
single-controller: one Python process drives every device and GSPMD puts
the collectives in. `torch.distributed` is multi-controller: the same
program runs once per rank. So every rank gets identical host inputs
(segments, pixels, batches, seeds) and keeps identical host state, holds
plain tensors for its own shard, and calls the collectives below where
GSPMD would put them. There is no DTensor dispatch: the kernels take plain
tensors, and no collective sits unseen between them.

`initialize` reads torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK) through env://. `backend=None` is NCCL for a CUDA device and
gloo for the CPU; a caller that wants gloo on CUDA tensors (several ranks
on one card, where NCCL refuses a duplicate device) passes it. Gloo takes
CUDA tensors in only some of its collectives and never in point-to-point
ops, so every collective here stages a CUDA tensor through host memory
when its group's backend is gloo (`_through_host`): explicit, and the same
for every op.

`Mesh` is a named-axis grid of global ranks in row-major order, as JAX's
`Mesh(devices.reshape(dims), axes)`, with one process group per line of
every axis and of every set of axes (the groups a collective over several
axes needs, e.g. the gradient sum over ("data", "seq")). Every rank builds
every group in the same order, as `torch.distributed.new_group` requires.
An axis of size 1 still gets its one-rank group when a process group
exists, so a world of one runs the collective code path (arithmetic
unchanged).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def initialize(
    backend: Optional[str] = None,
    *,
    device=None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> torch.device:
    """Initialise the default process group and return this rank's device:
    `device`, else cuda:LOCAL_RANK where CUDA is available, else the CPU.
    Unset arguments come from torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK; init_method None is env://, MASTER_ADDR and MASTER_PORT).
    backend=None: "nccl" for a CUDA device, "gloo" for the CPU."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        device = f"cuda:{local_rank}" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # env:// reads MASTER_ADDR / MASTER_PORT, and under torchrun joins its
    # agent's store (TORCHELASTIC_USE_AGENT_STORE) instead of binding the port
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return device


class Mesh:
    """Named axes over the world's first ranks, row-major (the last axis
    changes fastest). `shape` maps axis -> size in order; `devices` is the
    grid of global ranks; `member` is whether this rank is in it;
    `index(axis)` is this rank's coordinate; `group(axes)` / `ranks(axes)`
    are the process group and the global ranks of this rank's line along
    one axis or a set of axes (None / [rank] without a process group)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(a): int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        dims = tuple(self.shape.values())
        n = int(np.prod(dims)) if dims else 1
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n > world:
            raise ValueError(f"mesh {self.shape} needs {n} ranks, the world has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        # the world's first n ranks (as JAX's make_mesh takes the first n
        # devices); every rank of the world must build the mesh, members or not
        self.member = self.rank < n
        self.devices = np.arange(n).reshape(dims)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in np.unravel_index(self.rank, dims))))
                       if self.member else {})
        self._lines: Dict[Tuple[str, ...], List[int]] = {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                idx = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in idx]
                grid = self.devices.transpose(rest + idx).reshape(-1, int(np.prod(
                    [dims[i] for i in idx])))
                for line in grid:
                    line = [int(r) for r in line]
                    g = dist.new_group(line) if dist.is_initialized() else None
                    if self.rank in line:
                        self._lines[axes], self._groups[axes] = line, g

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axes)] or [1]))

    def index(self, axes: Axes) -> int:
        """This rank's position along its line of `axes` (row-major)."""
        key = self._key(axes)
        return self._lines[key].index(self.rank) if key else 0

    def group(self, axes: Axes):
        key = self._key(axes)
        return self._groups.get(key) if key else None

    def ranks(self, axes: Axes) -> List[int]:
        key = self._key(axes)
        return list(self._lines[key]) if key else [self.rank]

    def __contains__(self, axis: str) -> bool:
        return axis in self.shape


def make_slice_mesh(model_parallel: int = 4, data_axis: str = "data",
                    model_axis: str = "model") -> Mesh:
    """(data, model) mesh over the world, the model axis innermost (the ranks
    of a model line are neighbours: one host's cards under torchrun)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel:
        raise ValueError(f"world {n} is not a multiple of model_parallel {model_parallel}")
    return Mesh({data_axis: n // model_parallel, model_axis: model_parallel})


def make_multislice_mesh(num_slices: int, model_parallel: int,
                         axes: Tuple[str, str, str] = ("dcn", "data", "model")) -> Mesh:
    """(dcn, data, model) mesh: the outermost axis across slices (hosts),
    data and model inside one. Ranks are ordered by torchrun's global rank,
    which numbers one host's ranks together."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % num_slices or (n // num_slices) % model_parallel:
        raise ValueError(f"world {n} does not split into {num_slices} slices of "
                         f"model_parallel {model_parallel}")
    per = n // num_slices
    return Mesh(dict(zip(axes, (num_slices, per // model_parallel, model_parallel))))


def batch_spec(mesh) -> tuple:
    """The batch dim's axes: every data-like axis present (("dcn", "data") on
    a multi-slice mesh, ("data",) otherwise), as a one-entry spec."""
    axes = tuple(a for a in ("dcn", "data") if a in mesh.shape)
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


# ---------------------------------------------------------------------------
# Collectives (a group of None: a world of one, the identity)
# ---------------------------------------------------------------------------


def _through_host(group, t: torch.Tensor) -> bool:
    """Whether `t` goes through host memory for a collective of `group`: a
    CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: `t` reduced (sum or max) over the group's ranks, the
    same bits on every rank."""
    if group is None:
        return t.clone()
    x = t.detach().to("cpu", copy=True) if _through_host(group, t) else t.detach().clone()
    dist.all_reduce(x, _OPS[op], group=group)
    return x.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order."""
    if group is None:
        return t.clone()
    x = t.detach().to("cpu") if _through_host(group, t) else t.detach()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's equal part along `dim` of the group's sum."""
    if group is None:
        return t.clone()
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return all_reduce(t, group).chunk(n, dim=dim)[i].contiguous()


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of global rank `src` on every rank of the group (a new tensor)."""
    if group is None:
        return t.clone()
    x = t.detach().to("cpu", copy=True) if _through_host(group, t) else t.detach().clone()
    dist.broadcast(x.contiguous(), src, group=group)
    return x.to(t.device)


def _p2p(ops: List[Tuple[str, torch.Tensor, int]], group) -> None:
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend if kind == "send" else dist.irecv, x, peer, group)
        for kind, x, peer in ops])
    for r in reqs:
        r.wait()


def shift(tensors: Sequence[torch.Tensor], ranks: Sequence[int], group,
          step: int = 1) -> List[torch.Tensor]:
    """Each rank of the line `ranks` sends `tensors` to the rank `step`
    places after it and returns what the rank `step` places before it sent
    (a ring hop, JAX's ppermute by +step)."""
    n = len(ranks)
    if group is None or n == 1 or step % n == 0:
        return [t.clone() for t in tensors]
    me = ranks.index(dist.get_rank())
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    host = [_through_host(group, t) for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if h else t.device)
            for t, h in zip(tensors, host)]
    ops = []
    for t, o, h in zip(tensors, outs, host):
        x = t.detach().to("cpu") if h else t.detach()
        ops += [("send", x.contiguous(), dst), ("recv", o, src)]
    _p2p(ops, group)
    return [o.to(t.device) for o, t in zip(outs, tensors)]


def send(t: torch.Tensor, dst: int, group) -> None:
    """Point-to-point send to global rank `dst` (blocking)."""
    x = t.detach().to("cpu") if _through_host(group, t) else t.detach()
    _p2p([("send", x.contiguous(), dst)], group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of `like`'s shape, dtype and device from global rank `src`."""
    host = _through_host(group, like)
    out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
    _p2p([("recv", out, src)], group)
    return out.to(like.device)


def sharded_norm(tensors: Sequence[torch.Tensor], axes: Sequence[Tuple[str, ...]], mesh
                 ) -> torch.Tensor:
    """optax.global_norm of a sharded tree: each tensor's sum of squares (in
    f32) summed over the mesh axes it is split over (`axes`, one tuple a
    tensor), the replicated ones counted once; the same on every rank."""
    buckets: Dict[Tuple[str, ...], torch.Tensor] = {}
    for t, ax in zip(tensors, axes):
        sq = t.float().square().sum()
        buckets[ax] = buckets[ax] + sq if ax in buckets else sq
    total = None
    for ax in sorted(buckets):
        v = all_reduce(buckets[ax], mesh.group(ax)) if ax else buckets[ax]
        total = v if total is None else total + v
    return total.sqrt()
