"""The process group, the mesh of ranks and the data-parallel collectives
(port of xlxmert_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh and lets XLA
insert the collectives. The port runs one process per rank, as torchrun
launches them (the reference's NCCL DDP world, lxmert_pretrain.py:
688-700), and calls the collectives itself:
  - `initialize_multihost` / `maybe_initialize_multihost` start the
    process group. The backend is chosen and logged: nccl when every rank
    of the host has a card of its own, gloo on the CPU and when ranks
    share a card (NCCL refuses two ranks of one communicator on one
    device);
  - `make_mesh` lays the ranks out on ("data",), ("data", "model") or
    ("data", "pipe") with `init_device_mesh`; a run without a process
    group gets a one-rank mesh, on which every collective here is a
    no-op;
  - `shard_batch` keeps the JAX package's process-local contract (each
    rank passes its own slice, the global batch is local x data ranks);
    `replicate` broadcasts a module from the data group's first rank;
  - `all_reduce_mean` averages a gradient dict over the data group in
    one flat buffer per dtype. The engines take their gradients with
    `torch.autograd.grad`, whose results DistributedDataParallel's hooks
    never see, so there is no DDP wrapper.

Every collective goes through `all_reduce` / `broadcast` / `all_gather` /
`send` / `recv` here, which count their bytes and host time in `COMM`.
gloo carries CUDA tensors in all_reduce, broadcast and all_gather
(fp32 and bf16; scripts/probe_gloo_cuda_torch.py on the H100 machine,
torch 2.11); its send and recv write from the device pointer and abort
the process, so `send` / `recv` copy the pipeline's CUDA activations to
the host and back, and log the first such copy. The compute stays on
the card.
"""
from __future__ import annotations

import datetime
import math
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = (("data",), ("data", "model"), ("data", "pipe"))
TIMEOUT_S = 600.0
# every collective's count, bytes and host seconds (a gloo collective
# returns when it is done, an nccl one when it is queued)
COMM = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _say(msg: str) -> None:
    print(f"[rank {rank()}/{world_size()}] {msg}", file=sys.stderr,
          flush=True)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0 logs and writes."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def agree_min(n: int) -> int:
    """The least of every rank's `n` (e.g. the steps of an epoch when the
    ranks' shards differ by one example): every rank then runs as many
    collectives."""
    if world_size() == 1:
        return n
    dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.all_reduce(t, dist.ReduceOp.MIN)
    return int(t.item())


def _launch_env() -> Tuple[int, int, int, int]:
    """(world, rank, local_rank, local_world) of a torchrun or SLURM
    launch; torchrun's variables win."""
    env = os.environ
    if "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        rk = int(env.get("RANK", "0"))
        local = int(env.get("LOCAL_RANK", "0"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    else:
        world = int(env.get("SLURM_NTASKS", "1") or 1)
        rk = int(env.get("SLURM_PROCID", "0"))
        local = int(env.get("SLURM_LOCALID", "0"))
        local_world = int(env.get("SLURM_NTASKS_PER_NODE", str(world))
                          .split("(")[0])
        env.setdefault("LOCAL_RANK", str(local))
    return world, rk, local, local_world


def choose_backend(device="cuda", local_world: int = 1) -> Tuple[str, str]:
    """(backend, reason): nccl when the ranks run on cards and each rank
    of the host has a card of its own, else gloo."""
    if torch.device(device).type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", f"{local_world} ranks on {cards} cards"
    return "gloo", (f"{local_world} ranks share {cards} card(s): NCCL "
                    "takes one rank a device")


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None, device="cuda",
                         timeout: float = TIMEOUT_S) -> str:
    """Start the process group; returns its backend. With explicit
    arguments (an init method such as tcp://host:port or file://path,
    the world size and this rank) a failed rendezvous raises after
    `timeout` seconds, as does a missing rank in any later collective;
    without them the launch's environment (torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, or SLURM's) is read, and an incomplete
    one raises too: a silent single-process fallback would train every
    rank on the whole data and race on the output directory."""
    if initialized():
        return dist.get_backend()
    world, rk, local, local_world = _launch_env()
    if init_method is None:
        for v in ("MASTER_ADDR", "MASTER_PORT"):
            if v not in os.environ:
                raise RuntimeError(
                    f"a multi-process launch needs {v} in the environment "
                    "(torchrun sets it), or call initialize_multihost with "
                    "an init_method")
        init_method = "env://"
    if world_size is not None:
        world = world_size
        # one host unless the launcher says otherwise
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if rank is not None:
        rk = rank
        local = int(os.environ.get("LOCAL_RANK", str(rk)))
    backend, why = choose_backend(device, min(local_world, world))
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rk,
                            timeout=datetime.timedelta(seconds=timeout))
    _say(f"torch.distributed backend {backend} ({why})")
    return backend


def looks_multiprocess() -> bool:
    """torchrun's WORLD_SIZE > 1 with RANK, LOCAL_RANK and MASTER_ADDR;
    SLURM with more than one task; or XLXMERT_MULTIHOST=1."""
    env = os.environ
    if env.get("XLXMERT_MULTIHOST") == "1":
        return True
    if (int(env.get("WORLD_SIZE", "1") or 1) > 1
            and all(v in env for v in ("RANK", "LOCAL_RANK",
                                        "MASTER_ADDR"))):
        return True
    return int(env.get("SLURM_NTASKS", "1") or 1) > 1


def maybe_initialize_multihost(device="cuda") -> Optional[str]:
    """Called by every training CLI first: starts the process group only
    when the environment looks like a multi-process launch, so a
    single-process run pays nothing. Returns the backend or None."""
    if initialized() or not looks_multiprocess():
        return dist.get_backend() if initialized() else None
    return initialize_multihost(device=device)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


class Mesh:
    """Ranks laid out on named axes. `group(axis)` is the process group of
    this rank's line along `axis` (None where the axis has one rank),
    `index(axis)` this rank's place on it."""

    def __init__(self, shape: Dict[str, int], device_mesh=None,
                 index: Optional[Dict[str, int]] = None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self._index = dict(index or {a: 0 for a in shape})

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self._index.get(axis, 0)

    def group(self, axis: str):
        if self.size(axis) == 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def ranks(self, axis: str) -> Sequence[int]:
        """The global ranks of this rank's line along `axis`, in order."""
        g = self.group(axis)
        return [rank()] if g is None else dist.get_process_group_ranks(g)


def only_axes(mesh: Mesh, allowed: Tuple[str, ...], what: str) -> Mesh:
    """`mesh`, refused when an axis outside `allowed` has more than one
    rank: `what` would run those ranks as replicas that never meet."""
    extra = {a: n for a, n in mesh.shape.items()
             if a not in allowed and n > 1}
    if extra:
        raise ValueError(f"{what} runs on the mesh axes {allowed}; "
                         f"{extra} has no use there")
    return mesh


def make_mesh(shape: Tuple[int, ...] = (),
              axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh of every rank. An empty `shape` puts them all on the first
    axis; the axes are ("data",), ("data", "model") or ("data", "pipe"),
    the data axis first (rank = data index x the other axis' size +
    its index)."""
    axis_names = tuple(axis_names)
    if axis_names not in AXES:
        raise ValueError(f"mesh axes {axis_names}: use one of {AXES}")
    world = world_size()
    shape = tuple(shape) or (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over {axis_names} does not "
                         f"hold the {world} ranks of the process group")
    if world == 1:
        return Mesh(dict(zip(axis_names, shape)))
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh only carries the groups: the device type follows the
    # backend (gloo's groups carry CUDA tensors too, see the docstring)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(dev, shape, mesh_dim_names=axis_names)
    index = {a: dm.get_local_rank(a) for a in axis_names}
    return Mesh(dict(zip(axis_names, shape)), dm, index)


# ---------------------------------------------------------------------------
# collectives, counted in COMM
# ---------------------------------------------------------------------------

_staged_said: set = set()


def _staged(op: str, t: torch.Tensor) -> bool:
    """Whether a point-to-point `op` on `t` goes through host memory:
    gloo's send and recv take no CUDA tensor."""
    if not t.is_cuda or dist.get_backend() != "gloo":
        return False
    if op not in _staged_said:
        _staged_said.add(op)
        _say(f"gloo carries no CUDA {op}: staged through host memory")
    return True


class _Count:
    def __init__(self, t: torch.Tensor):
        self.nbytes = t.numel() * t.element_size()

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        COMM["calls"] += 1
        COMM["bytes"] += self.nbytes
        COMM["seconds"] += time.perf_counter() - self.t0


def reset_comm() -> None:
    COMM.update(calls=0, bytes=0, seconds=0.0)


def all_reduce(t: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group` (the world when None); returns `t`."""
    with _Count(t):
        dist.all_reduce(t, op, group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In place from global rank `src`; returns `t`."""
    with _Count(t):
        dist.broadcast(t, src, group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (one shape), concatenated along `dim` in rank
    order."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    with _Count(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group)
    return torch.cat(parts, dim)


def send(t: torch.Tensor, dst: int) -> None:
    with _Count(t):
        dist.send(t.cpu() if _staged("send", t) else t.contiguous(), dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor shaped as `like`, received from global rank `src`."""
    with _Count(like):
        if _staged("recv", like):
            h = torch.empty(like.shape, dtype=like.dtype)
            dist.recv(h, src)
            return h.to(like.device)
        out = torch.empty_like(like)
        dist.recv(out, src)
        return out


def all_reduce_mean(grads: Dict[str, Optional[torch.Tensor]],
                    group) -> Dict[str, Optional[torch.Tensor]]:
    """The mean of a gradient dict over `group`, through one flat buffer
    per dtype (None gradients stay None: every rank must hold the same
    set). A no-op for a one-rank group (None)."""
    if group is None:
        return grads
    n = dist.get_world_size(group)
    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for name, g in grads.items():
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(name)
    for names in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        all_reduce(flat, group)
        flat.div_(n)
        off = 0
        for k in names:
            m = grads[k].numel()
            out[k] = flat[off:off + m].view_as(grads[k])
            off += m
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward and backward: a statistic summed over
    the ranks' batches, each rank's loss reaching every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, differentiable (a new tensor)."""
    return _AllReduceSum.apply(x, group)


def mean_over(values: Dict[str, torch.Tensor], group
              ) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over `group` in one fp32 all-reduce
    (detached)."""
    if group is None or not values:
        return {k: v.detach() for k, v in values.items()}
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    all_reduce(flat, group).div_(dist.get_world_size(group))
    return {k: flat[i] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# batches and replicas
# ---------------------------------------------------------------------------


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                process_local: Optional[bool] = None
                ) -> Dict[str, np.ndarray]:
    """This rank's host batch. Process-local (the default in a
    multi-process run): each rank passes its own slice, what its
    `dataset.shard(data index, data ranks)`-ed loader yields, and the
    global batch is local_batch x the data ranks (the reference's
    per-rank --batchSize). Otherwise `batch` is the global batch and the
    rank takes its data index's rows."""
    if process_local is None:
        process_local = world_size() > 1
    leaves = [v for v in batch.values() if hasattr(v, "shape")]
    if process_local:
        return batch
    n_data = mesh.size("data")
    if leaves and leaves[0].shape[0] % n_data:
        raise ValueError(
            f"global batch size {leaves[0].shape[0]} must be divisible by "
            f"the data-axis size {n_data} (devices in the mesh); "
            f"pick --batchSize as a multiple of {n_data}")
    i = mesh.index("data")

    def take(v):
        if not hasattr(v, "shape"):
            return v
        b = v.shape[0] // n_data
        return v[i * b:(i + 1) * b]

    return {k: take(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from the first rank of
    this rank's data group (pure DP starts every replica from rank 0's
    weights)."""
    group = mesh.group("data")
    if group is None:
        return module
    src = mesh.ranks("data")[0]
    for t in list(module.parameters()) + list(module.buffers()):
        broadcast(t.data, src, group)
    return module
