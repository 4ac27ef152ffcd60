"""Megatron-style tensor parallelism over the mesh's "model" axis (port of
xlxmert_tpu/parallel/sharding.py).

The JAX package marks each parameter with a PartitionSpec and lets GSPMD
insert the collectives; the port keeps the same markers, read on the
flax path that `core/convert.flax_path` gives each torch name, and calls
the collectives itself:
  - COLUMN-parallel: the attention q/k/v projections and the FFN
    intermediate with their biases. The torch weight is (out, in), so
    each rank keeps a block of the out rows: its H/tp heads, its share of
    the hidden units;
  - ROW-parallel: `output/dense` (the attention output projection, the
    FFN output). Each rank keeps a block of the in columns, multiplies
    its slice of the activation, and the partial products are summed
    across the model group before the (replicated) bias is added;
  - everything else (embeddings, LayerNorms, heads) is replicated.

Megatron's pair of collectives carries the gradients:
`copy_to_model_group` (identity forward, all-reduce backward) on the
input of each column-parallel block, `reduce_from_model_group`
(all-reduce forward, identity backward) on each row-parallel output.
The reductions run in fp32 and round back to the activation's type.

The attention-probability dropout of a sharded attention draws the mask
of all H heads and keeps its own: every rank of a model group draws the
same numbers, in the same order, as one process would, so a replicated
activation gets one mask on every rank and a sharded one the mask a
single process would give its heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from xlxmert_tpu_torch.core.convert import flax_path
from xlxmert_tpu_torch.parallel import mesh as pmesh

COLUMN_MARKERS = ("/query/", "/key/", "/value/", "/intermediate/",
                  "_inter/")
ROW_MARKERS = ("output/dense",)


def lxmert_param_spec(name: str, ndim: int) -> Optional[int]:
    """The torch dimension of parameter `name` split over the model axis
    (0: a column-parallel weight's out rows or its bias; 1: a
    row-parallel weight's in columns), or None where it is replicated:
    the JAX package's rule on the flax path."""
    path, _ = flax_path(name, ndim)
    if path is None:
        return None
    p = "/".join(path) + "/"
    if ndim == 2:
        if any(m in p for m in COLUMN_MARKERS):
            return 0
        if any(m in p for m in ROW_MARKERS):
            return 1
    if (ndim == 1 and any(m in p for m in COLUMN_MARKERS)
            and p.rstrip("/").endswith("bias")):
        return 0
    return None


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    pmesh.all_reduce(y, group)
    return y.to(x.dtype)


class _CopyToModelGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModelGroup.apply(x, group)


class TensorParallel:
    """This rank's place on the model axis: its group, the group's size
    and its index, and the slicing of parameters by lxmert_param_spec."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    @classmethod
    def from_mesh(cls, mesh: pmesh.Mesh, axis: str = "model"
                  ) -> Optional["TensorParallel"]:
        if mesh.size(axis) == 1:
            return None
        return cls(mesh.group(axis), mesh.size(axis), mesh.index(axis))

    def split(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor `name`."""
        dim = lxmert_param_spec(name, full.dim())
        if dim is None:
            return full
        n = full.shape[dim]
        if n % self.size:
            raise ValueError(f"{name}: {n} does not split over {self.size} "
                             "model ranks")
        b = n // self.size
        return full.narrow(dim, self.index * b, b).contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor `name` from every rank's slice (a collective:
        every rank of the model group calls it, in one order)."""
        dim = lxmert_param_spec(name, local.dim())
        if dim is None:
            return local
        return pmesh.all_gather(local, self.group, dim)

    def full_shape(self, name: str, shape: Tuple[int, ...]
                   ) -> Tuple[int, ...]:
        dim = lxmert_param_spec(name, len(shape))
        if dim is None:
            return tuple(shape)
        return tuple(s * self.size if i == dim else s
                     for i, s in enumerate(shape))

    def gather_dict(self, tensors: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        return {k: self.gather(k, v) for k, v in tensors.items()}

    def split_dict(self, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: self.split(k, v) for k, v in tensors.items()}

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the full gradient: the squares of the
        sharded leaves summed over the model group, each replicated
        leaf counted once."""
        sharded = [g for k, g in grads.items()
                   if lxmert_param_spec(k, g.dim()) is not None]
        replicated = [g for k, g in grads.items()
                      if lxmert_param_spec(k, g.dim()) is None]

        def sq(ts):
            if not ts:
                return torch.zeros((), dtype=torch.float32,
                                   device=next(iter(grads.values())).device)
            return torch.stack([torch.sum(t.float() * t.float())
                                for t in ts]).sum()

        total = pmesh.all_reduce(sq(sharded).reshape(1), self.group)[0]
        return torch.sqrt(total + sq(replicated))


def shard_params(model: nn.Module, tp: TensorParallel) -> nn.Module:
    """Keep this rank's slice of every sharded parameter of an LXMERT
    model (as a plain tensor in a new Parameter) and switch its
    attention, intermediate and row-parallel dense modules to their
    tensor-parallel forwards. Call before the optimizer is built."""
    from xlxmert_tpu_torch.models.lxmert import (
        Attention, Dense, Intermediate,
    )

    with torch.no_grad():
        for mname, mod in model.named_modules():
            for pname, p in list(mod.named_parameters(recurse=False)):
                full = f"{mname}.{pname}" if mname else pname
                local = tp.split(full, p.data)
                if local is not p.data:
                    setattr(mod, pname, nn.Parameter(local))
    for mname, mod in model.named_modules():
        if isinstance(mod, Attention):
            dim = lxmert_param_spec(f"{mname}.query.weight", 2)
            if dim != 0:
                continue
            H = mod.n_heads
            if H % tp.size:
                raise ValueError(f"{H} heads do not split over {tp.size} "
                                 "model ranks")
            mod.n_heads = H // tp.size
            mod.tp_group = tp.group
            mod.dropout.heads = (tp.index * mod.n_heads, H)
        elif isinstance(mod, Intermediate):
            if lxmert_param_spec(f"{mname}.dense.weight", 2) == 0:
                mod.tp_group = tp.group
        elif isinstance(mod, Dense):
            if lxmert_param_spec(f"{mname}.weight", 2) == 1:
                mod.reduce_group = tp.group
    return model
