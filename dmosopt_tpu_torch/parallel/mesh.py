"""Device mesh over ``torch.distributed``: process groups, population
sharding and the sharded rank.

Port of ``dmosopt_tpu/parallel/mesh.py:47-211``. The JAX package runs one
controller process over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Torch's idiom is one process per device under
``torch.distributed``, with a `torch.distributed.device_mesh.DeviceMesh`
naming the axes (``"pop"``, and ``"model"`` on a 2-axis mesh) and every
collective written out. The port's design, which its tests hold to the
JAX package's oracles (a sharded run equals the unsharded one: bitwise
for ranks and selected indices, within float tolerance for fits):

- **The EA state is replicated.** Every rank runs the same driver with
  the same seeds, so every rank holds the same state; no rank ever
  holds a shard of it.
- **Only row-proportional work is split** over the mesh's first axis,
  with one collective each: the rank (`non_dominated_rank_sharded`:
  each rank relaxes its slice of the lex-sorted rows, then one
  ``all_reduce(MAX)`` a relaxation step), each generation's surrogate
  predict (`models.predictor` ``query_sharding``: each rank predicts its
  slice of the queries, one ``all_gather``) and a batch evaluation
  (`parallel.evaluator.TorchBatchEvaluator` with ``mesh``: each rank
  evaluates its slice of the rows, one ``all_gather`` an output). The
  surrogate fit splits its restarts over a ``"model"`` axis
  (`models.gp.fit_gp_batch`) or, with ``surrogate_mesh``, its Cholesky
  over row slabs (`models.gp_sharded`).
- `shard_population` and `shard_state` give this rank's row block of an
  array or of a state's population-leading fields (the layout a sharded
  call works on); `population_sharding` and `replicate` name the two
  layouts.

Backends follow the devices: NCCL for CUDA, gloo for the CPU. NCCL
refuses two ranks on one device, so two ranks sharing one card run
gloo (``backend="gloo"``); gloo's collectives are written for host
memory, so the mesh moves a CUDA operand through the host for every
collective of a gloo group (`_collective`), on every gloo run alike and
never as a retry.

A mesh spans every rank of the process group (one process per device);
`create_mesh` with no group initializes a one-process group over an
in-process store, so ``run(mesh=create_mesh(1))`` needs no cluster.
"""

from __future__ import annotations

import datetime
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dmosopt_tpu_torch.ops.dominance import CHECK_EVERY, _dominates, _lex_order

# a hung collective (a rank that died) fails the cluster in bounded time
_TIMEOUT = datetime.timedelta(seconds=600)


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_device(device) -> torch.device:
    """This rank's device: ``device``, or (None) the current CUDA device,
    raising without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu'"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _local_cuda_device(rank: int) -> torch.device:
    """Card ``rank % device_count`` of this host, made the current CUDA
    device: one process per card, ranks numbered host by host."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> int:
    """Initialize this process's ``torch.distributed`` group (the
    counterpart of ``jax.distributed.initialize``); returns its rank.

    ``coordinator_address`` is ``"host:port"`` of rank 0's store, every
    process passes the same ``num_processes`` and its own
    ``process_id``. With one process and no address the group lives on
    an in-process store. ``device`` is this rank's device (None: a CUDA
    device, raising without one; in a cluster card ``process_id %
    device_count``, made current; the CPU only when asked for).
    ``backend`` None follows ``device`` (NCCL for CUDA, gloo for the
    CPU); ``"gloo"`` runs several ranks on one card. A process whose
    group is already initialized keeps it."""
    given = device
    device = _rank_device(device)
    if dist.is_initialized():
        return dist.get_rank()
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    if given is None and world > 1:
        device = _local_cuda_device(rank)
    backend = backend or _backend_for(device)
    if world == 1 and coordinator_address is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_TIMEOUT)
    else:
        if coordinator_address is None:
            raise ValueError("a cluster of several processes needs a coordinator_address")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}", rank=rank,
            world_size=world, timeout=_TIMEOUT,
        )
    return rank


def is_primary_process() -> bool:
    """True on the process that owns the store's writes: every
    single-process run, and rank 0 of a cluster (the reference's rank-0
    controller, ``dmosopt_tpu/driver.py:68``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("pop",),
    shape: Optional[Sequence[int]] = None,
    device=None,
) -> DeviceMesh:
    """A `DeviceMesh` over the process group's ranks, one device each
    (``dmosopt_tpu/parallel/mesh.py:64``). ``n_devices`` (default: the
    group's size) must equal the group's size; with one axis name the
    mesh is 1-D over the population, ``shape`` lays out several axes
    (e.g. ``("pop", "model")``, ``(2, 1)``). ``device`` is this rank's
    device (None: the current CUDA device, raising without one); without
    an initialized group, one process gets a group of its own."""
    device = _rank_device(device)
    if not dist.is_initialized():
        initialize_distributed(device=device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh spans every rank of the process group (one process per "
            f"device): asked for {n} devices, the group has {world}"
        )
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not lay out {n} devices "
                         f"over axes {axis_names}")
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


class Sharding(NamedTuple):
    """A layout on a mesh: rows split over ``axis`` in equal contiguous
    blocks, or replicated (``axis`` None)."""

    mesh: DeviceMesh
    axis: Optional[str]


def population_sharding(mesh: DeviceMesh, axis: str = "pop") -> Sharding:
    return Sharding(mesh, axis)


def replicate(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, None)


def row_block(n: int, n_shards: int, index: int):
    """(start, stop) of shard ``index``'s rows of ``n`` split into
    ``n_shards`` blocks of ``ceil(n / n_shards)`` (the last ones may be
    short or empty)."""
    L = -(-n // n_shards)
    return min(index * L, n), min((index + 1) * L, n)


def shard_population(x: torch.Tensor, mesh: DeviceMesh, axis: str = "pop") -> torch.Tensor:
    """This rank's block of ``x``'s leading axis split over ``axis``
    (``dmosopt_tpu/parallel/mesh.py:87``)."""
    a, b = row_block(x.shape[0], axis_size(mesh, axis), axis_index(mesh, axis))
    return x[a:b]


def shard_state(state, pop: int, mesh: DeviceMesh, axis: str = "pop"):
    """The state with every field whose leading dimension is ``pop``
    replaced by this rank's block of it and every other field kept
    (``dmosopt_tpu/parallel/mesh.py:196``): the layout a sharded call
    takes. The EA itself keeps its state replicated."""
    from dataclasses import fields

    out = {}
    for f in fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == pop:
            v = shard_population(v, mesh, axis)
        out[f.name] = v
    return type(state)(**out)


# ----------------------------------------------------------- collectives


def _collective(fn, tensors, group):
    """Run ``fn`` on ``tensors`` (a list, filled in place) over
    ``group``; a gloo group gets host copies of CUDA operands, copied
    back after."""
    if dist.get_backend(group) == "gloo" and any(t.is_cuda for t in tensors):
        host = [t.cpu() for t in tensors]
        fn(host)
        for t, h in zip(tensors, host):
            t.copy_(h)
        return tensors
    fn(tensors)
    return tensors


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str, op=dist.ReduceOp.SUM):
    """``t`` reduced over ``axis`` (a new tensor)."""
    group = mesh.get_group(axis)
    out = t.clone()
    if axis_size(mesh, axis) > 1:
        _collective(lambda ts: dist.all_reduce(ts[0], op=op, group=group), [out], group)
    return out


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    rank order over ``axis``."""
    W = axis_size(mesh, axis)
    if W == 1:
        return t
    group = mesh.get_group(axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(W)]

    def gather(ts):
        dist.all_gather(ts[1:], ts[0], group=group)

    _collective(gather, [t] + parts, group)
    return torch.cat(parts, dim=dim)


def ring_shift(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ``t`` of the previous rank along ``axis`` (each rank sends its
    own to the next, cyclically): one stage of a ring."""
    W = axis_size(mesh, axis)
    if W == 1:
        return t
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    p = axis_index(mesh, axis)
    send = t.contiguous()
    recv = torch.empty_like(send)

    def shift(ts):
        ops = [dist.P2POp(dist.isend, ts[0], ranks[(p + 1) % W], group=group),
               dist.P2POp(dist.irecv, ts[1], ranks[(p - 1) % W], group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _collective(shift, [send, recv], group)
    return recv


def gather_rows(fn, x: torch.Tensor, mesh: DeviceMesh, axis: str):
    """``fn(x)`` computed with ``x``'s rows split over ``axis``: the rows
    are padded (repeating the last) to equal blocks, each rank applies
    ``fn`` to its block, and every output of ``fn`` (a tensor or a tuple
    of row-aligned tensors) is gathered in row order and trimmed. Row
    results equal the unsplit call's where ``fn`` computes rows
    independently."""
    W = axis_size(mesh, axis)
    if W == 1:
        return fn(x)
    n = x.shape[0]
    L = -(-n // W)
    if W * L > n:
        x = torch.cat([x, x[-1:].expand((W * L - n,) + tuple(x.shape[1:]))], dim=0)
    p = axis_index(mesh, axis)
    out = fn(x[p * L:(p + 1) * L])
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    gathered = tuple(all_gather(o, mesh, axis, dim=0)[:n] for o in outs)
    return gathered[0] if single else gathered


# --------------------------------------------------------- sharded rank


def non_dominated_rank_sharded(
    Y: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "pop",
    mask=None,
    tile: Optional[int] = None,
) -> torch.Tensor:
    """`ops.dominance.non_dominated_rank` with the pairwise work split
    over ``mesh``'s ``axis`` (``dmosopt_tpu/parallel/mesh.py:94-195``).

    Every rank holds ``Y`` (n, d) and puts its rows in lexicographic
    order (a topological order of dominance), padded with masked rows to
    a multiple of the axis size. Rank p owns the rows of block p and
    builds their dominance rows against every row, ``tile`` rows at a
    time ((n / shards) x n booleans a rank, never n x n). A relaxation
    step takes, for each column, the longest chain through this rank's
    rows, and one ``all_reduce(MAX)`` merges the ranks' contributions;
    the step repeats until the ranks stop changing (checked every
    `CHECK_EVERY` steps, the same on every rank because the merged ranks
    are). The fixed point is the longest dominator chain of every row,
    so the ranks equal the single-device ones bit for bit: integer max
    is exact in any order. Masked rows get rank n and never dominate."""
    n = Y.shape[0]
    dev = Y.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else mask.to(device=dev, dtype=torch.bool))
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    W = axis_size(mesh, axis)
    L = -(-n // W)
    npad = W * L
    order = _lex_order(Y)
    Ys = Y[order]
    vs = valid[order]
    if npad > n:
        Ys = torch.cat([Ys, Ys[-1:].expand(npad - n, Ys.shape[1])], dim=0)
        vs = torch.cat([vs, torch.zeros(npad - n, dtype=torch.bool, device=dev)])
    p = axis_index(mesh, axis)
    rows = slice(p * L, (p + 1) * L)
    B = int(tile) if tile is not None else L
    dom = torch.empty((L, npad), dtype=torch.bool, device=dev)
    for r0 in range(0, L, B):
        a, b = p * L + r0, p * L + min(r0 + B, L)
        dom[r0:r0 + B] = _dominates(Ys[a:b], Ys) & vs[a:b, None] & vs[None, :]
    r = torch.zeros(npad, dtype=torch.int32, device=dev)
    for _ in range(-(-(npad + 1) // CHECK_EVERY)):
        for _ in range(CHECK_EVERY):
            prev = r
            local = torch.where(dom, (r[rows] + 1)[:, None], 0).amax(dim=0)
            r = torch.maximum(r, all_reduce(local.to(torch.int32), mesh, axis,
                                            op=dist.ReduceOp.MAX))
        if torch.equal(r, prev):
            break
    rank = torch.empty(n, dtype=torch.int32, device=dev).scatter_(0, order, r[:n])
    return torch.where(valid, rank, n).to(torch.int32)
