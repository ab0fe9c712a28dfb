"""Data parallelism over ``torch.distributed`` (the port of
``caiman_asr_tpu/parallel/mesh.py``).

One process a card. A process is what a JAX host is: it loads its own rows
of each global batch (``data/sampler.py``: rank r takes ``batch[r::world]``),
and the train step sums its gradients with every other rank's in one flat
fp32 all-reduce (``all_reduce_flat``) before the update, which every rank
then makes alike. Parameters, EMA and moments are replicated:
``broadcast_tree`` makes them equal to rank 0's to the bit once, after
initialisation or a resume, and the identical reduced gradient keeps them so.

The JAX module's sharding helpers (``make_mesh``, ``replicated``,
``batch_sharding``, ``shard_batch``, ``shard_batch_multihost``) have no
counterpart here: a rank holds only its own rows, so there is no global
array to lay out. Their work is done by the sampler's shard, by the train
step's all-reduce (``training/step.py``) and, for batch-norm statistics, by
``AllReduceSum`` (``ops/lstm.py``).

Model parallelism (``--model_parallel M``, ``init_model_parallel``) splits
the world into (data x model) as the JAX trainer reshapes its devices
(``caiman_asr_tpu/train.py:225-230``): rank = data_i * M + model_j. The M
ranks of a model group share their rows and hold one vocab shard each of
the joint's last layer and the pruned loss's heads
(``parallel/vocab_parallel.py``); the ranks of a data group hold the same
shard and sum their gradients. Where the world is not a multiple of M the
layout is refused (the JAX trainer drops devices silently there).

The backend follows one rule, printed by ``init_multihost``:

- ``gloo`` on the CPU;
- ``nccl`` when every rank on a host has a card of its own;
- ``gloo`` with CUDA tensors when more ranks than cards share a host (two
  ranks on one card: NCCL refuses two ranks on one device).

No failure is caught and retried on another backend.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# set by init_multihost: the backend, this rank's device and the device on
# which the small host-value collectives run (the card's for NCCL)
_STATE: Dict[str, object] = {"backend": None, "device": None, "host_device": None}
# set by init_model_parallel: M and this rank's two groups (None where a
# group would hold one rank)
_LAYOUT: Dict[str, object] = {"model_parallel": 1, "model_group": None, "data_group": None}


def backend_rule(device_type: str, local_world: int, n_cards: int) -> Tuple[str, str]:
    """(backend, why) for ranks on ``device_type`` with ``local_world``
    ranks on this host and ``n_cards`` cards in it."""
    if device_type == "cpu":
        return "gloo", "the CPU"
    if local_world <= n_cards:
        return "nccl", f"{local_world} rank(s) on this host, {n_cards} card(s): one card a rank"
    return "gloo", (f"{local_world} ranks on this host share {n_cards} card(s): NCCL refuses "
                    "two ranks on one device, gloo reduces CUDA tensors through host memory")


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device="cuda") -> Tuple[int, int]:
    """Join the process group; returns (rank, world).

    Under ``torch.distributed.run`` (``WORLD_SIZE`` in the environment) the
    launcher's ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` and its
    rendezvous are used. Otherwise the JAX flags say it: ``coordinator``
    (``--coordinator_address``, a ``host:port`` or an init URL such as
    ``tcp://host:port`` or ``file:///path``), ``num_processes``
    (``--num_hosts``) and ``process_id`` (``--host_id``), one process a host.
    On the card the rank's device is ``cuda:LOCAL_RANK`` (modulo the cards
    when ranks share them) and becomes the current device."""
    env = os.environ
    if "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", 0))
        init_method = "env://"
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("outside torch.distributed.run, --multihost needs "
                             "--coordinator_address, --num_hosts and --host_id")
        world, rank = int(num_processes), int(process_id)
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    local_rank = int(env.get("LOCAL_RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--multihost on 'cuda' but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    else:
        n_cards = 0
    backend, why = backend_rule(dev.type, local_world, n_cards)
    print(f"torch.distributed: rank {rank} of {world}, backend {backend} ({why}), device {dev}",
          flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _STATE.update(backend=backend, device=dev,
                  host_device=dev if backend == "nccl" else torch.device("cpu"))
    return rank, world


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def device() -> Optional[torch.device]:
    """The device ``init_multihost`` gave this rank."""
    return _STATE["device"]


def backend() -> Optional[str]:
    return _STATE["backend"]


def group():
    """The default group above one process, else None (the one-process
    path, untouched)."""
    return dist.group.WORLD if world() > 1 else None


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None, host_device=None)
    _LAYOUT.update(model_parallel=1, model_group=None, data_group=None)


def init_model_parallel(m: int) -> Tuple[int, int]:
    """Split the world into (data x model) with ``m`` ranks a model group:
    rank = data_i * m + model_j. Every rank makes every group, in one order.
    Returns (data rank, model rank). Raises where the world is not a
    multiple of ``m``."""
    m, w, r = int(m), world(), rank()
    if m < 1 or w % m:
        raise ValueError(f"--model_parallel {m} needs a world that is a multiple of it; "
                         f"the world is {w} process(es)")
    model_g = data_g = None
    if m > 1:
        for i in range(w // m):
            g = dist.new_group(list(range(i * m, (i + 1) * m)))
            if r // m == i:
                model_g = g
    if w // m > 1:
        for j in range(m):
            g = dist.new_group(list(range(j, w, m)))
            if r % m == j:
                data_g = g
    _LAYOUT.update(model_parallel=m, model_group=model_g, data_group=data_g)
    return r // m, r % m


def model_parallel() -> int:
    return int(_LAYOUT["model_parallel"])


def model_group():
    """This rank's model group (the ranks that share its rows and split the
    vocabulary), None without model parallelism."""
    return _LAYOUT["model_group"]


def model_rank() -> int:
    return rank() % model_parallel()


def data_rank() -> int:
    """The shard of the data this rank loads: its rank without model
    parallelism."""
    return rank() // model_parallel()


def data_world() -> int:
    return world() // model_parallel()


def data_group():
    """The group over which gradients and evaluations are summed: the ranks
    that hold one vocab shard (the default group without model parallelism);
    None where it would hold one rank."""
    if model_parallel() == 1:
        return group()
    return _LAYOUT["data_group"]


def _host_device() -> torch.device:
    return _STATE["host_device"] or torch.device("cpu")


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """One SUM all-reduce over ``tensors`` flattened in their order into a
    single fp32 buffer; returns the summed tensors in their shapes (fp32).
    The train step's gradient all-reduce (its loss rides at the end)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_ints(values: Sequence[int], op: str = "max") -> List[int]:
    """``values`` reduced over the ranks (``"max"``, ``"min"`` or ``"sum"``)."""
    if world() == 1:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=_host_device())
    dist.all_reduce(t, op={"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                           "sum": dist.ReduceOp.SUM}[op])
    return [int(v) for v in t.tolist()]


def all_reduce_floats(values: Sequence[float]) -> List[float]:
    """``values`` summed in float64 over this rank's data group (one rank a
    vocab shard), so that the ranks of a model group, which hold the same
    rows, count them once; over every rank without model parallelism."""
    if data_world() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=_host_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=data_group())
    return [float(v) for v in t.tolist()]


def all_gather_objects(obj, data_only: bool = False) -> list:
    """One picklable object a rank, gathered to every rank in rank order;
    with ``data_only`` one a data rank, from this rank's data group."""
    n = data_world() if data_only else world()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=data_group() if data_only else None)
    return out


@torch.no_grad()
def broadcast_tree(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy rank ``src``'s values into ``tensors`` on every rank, in place:
    one broadcast a dtype over the tensors flattened in their order."""
    if world() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        ts = by_dtype[dtype]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src)
        at = 0
        for t in ts:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()


@torch.no_grad()
def gather_rows(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Every rank's ``t`` joined on ``axis`` in the sampler's order: global
    row ``j * world + r`` is rank r's row j, as rank r takes
    ``batch[r::world]``. Returned on every rank, on ``t``'s device."""
    if world() == 1:
        return t
    parts = [torch.empty_like(t, device=_host_device()) for _ in range(world())]
    dist.all_gather(parts, t.to(_host_device()).contiguous())
    return torch.stack(parts, dim=axis + 1).flatten(axis, axis + 1).to(t.device)


def take_rows(t: torch.Tensor, axis: int, rank_: int, world_: int) -> torch.Tensor:
    """Rank ``rank_``'s rows of a global ``t`` (``gather_rows``' layout)."""
    idx = torch.arange(rank_, t.shape[axis], world_, device=t.device)
    return t.index_select(axis, idx)


class AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce under autograd: the backward all-reduces the
    incoming gradient (each rank's loss depends on the sum through its own
    use of it, so the gradient of the sum is the sum of those)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class PsumKeepCt(torch.autograd.Function):
    """``y = sum over group(x)`` whose backward keeps the cotangent
    (dL/dx = dL/dy), for tensors the ranks of a model group go on to use
    alike: each rank's loss is the whole loss, so its cotangent is already
    the whole one (JAX's ``_psum_keep_ct``, ``ops/pruned_loss.py:82-97``).
    One all-reduce over the inputs flattened in their order."""

    @staticmethod
    def forward(ctx, group, *xs: torch.Tensor):
        flat = torch.cat([x.reshape(-1).float() for x in xs])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        out, at = [], 0
        for x in xs:
            out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
            at += x.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        return (None, *cts)


class IdentPsumCt(torch.autograd.Function):
    """``y = x`` for a tensor the ranks of a model group hold alike, whose
    backward sums the cotangent over the group: each rank's cotangent is the
    part that flows through its own vocab shard (JAX's ``_ident_psum_ct``,
    ``ops/pruned_loss.py:100-111``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        g = ct.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None
