"""GPipe pipeline parallelism over the mesh's "pipe" axis (port of
xlxmert_tpu/parallel/pipeline.py).

The JAX package stacks L homogeneous layers to (L, ...) leaves, shards
the layer axis over `pipe` and runs the microbatch schedule in one
shard_map; the port keeps each stage's layers as modules on its rank:
  - `stack_layers` / `stack_language_layers` stack the per-layer state
    dicts of the port's `encoder.layer.{i}` modules to (L, ...) tensors;
  - `place_pipeline` gives this rank its stage's L/S consecutive layers;
  - `pipeline_apply` runs the schedule: M microbatches flow through S
    stages over M + S - 1 ticks, stage s working on microbatch t - s at
    tick t, the activations sent stage to stage (send/recv). It is one
    autograd Function: its forward keeps each tick's graph, and its
    backward runs the ticks in reverse, sending each microbatch's input
    gradient back up the ring. The output is returned on every rank of
    the pipe group (broadcast from the last stage, as the JAX psum
    replicates it); its gradient is taken from the last stage's copy, so
    every rank of the pipe group computes the loss and calls backward
    (the reverse ring is a collective). Each data rank runs its own
    microbatch stream on its local batch.

The bubble is the usual (S - 1)/(M + S - 1) share of idle ticks;
`PIPE_STATS` holds the last forward's wall and busy seconds on this rank
(each tick's compute timed to its end), so the measured share is
1 - busy / wall.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from xlxmert_tpu_torch.parallel import mesh as pmesh

PIPE_STATS = {"wall_s": 0.0, "busy_s": 0.0, "ticks": 0, "stage_ticks": 0}


def stack_layers(layers: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """Per-layer state dicts stacked to (L, ...) tensors."""
    sds = [m.state_dict() for m in layers]
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}


def stack_language_layers(model: nn.Module, n_layers: int
                          ) -> Dict[str, torch.Tensor]:
    """The LXMERT language stack (`encoder.layer.{i}` of an LxmertModel,
    or of the `bert` of a model holding one) stacked."""
    enc = model.bert.encoder if hasattr(model, "bert") else model.encoder
    return stack_layers([enc.layer[i] for i in range(n_layers)])


def place_pipeline(stacked: Dict[str, torch.Tensor],
                   make_layer: Callable[[], nn.Module], mesh: pmesh.Mesh,
                   pipe_axis: str = "pipe", device=None) -> nn.ModuleList:
    """This rank's stage: layers s * L/S .. (s + 1) * L/S - 1 of the
    stack, built by `make_layer` and loaded from their slices."""
    L = next(iter(stacked.values())).shape[0]
    S, s = mesh.size(pipe_axis), mesh.index(pipe_axis)
    if L % S:
        raise ValueError(f"{L} layers do not split over {S} pipeline "
                         "stages")
    per = L // S
    stage = nn.ModuleList()
    for i in range(s * per, (s + 1) * per):
        layer = make_layer()
        layer.load_state_dict({k: v[i] for k, v in stacked.items()})
        stage.append(layer)
    return stage.to(device) if device is not None else stage


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, n_carry, *inputs):
        carry, params = inputs[:n_carry], inputs[n_carry:]
        S, s, M = run["S"], run["s"], run["M"]
        ranks = run["ranks"]
        micro = [tuple(t[j * t.shape[0] // M:(j + 1) * t.shape[0] // M]
                       for t in carry) for j in range(M)]
        saved: Dict[int, Tuple[tuple, tuple]] = {}
        outs: List[tuple] = []
        busy = 0.0
        t_start = time.perf_counter()
        for t in range(M + S - 1):
            i = t - s
            if not 0 <= i < M:
                continue
            if s == 0:
                inp = micro[i]
            else:
                inp = tuple(pmesh.recv(x, ranks[s - 1]) for x in micro[i])
            leaves = tuple(x.detach().requires_grad_(x.is_floating_point())
                           for x in inp)
            t0 = time.perf_counter()
            with torch.enable_grad():
                out = run["stage"](leaves)
            if out[0].is_cuda:
                torch.cuda.synchronize(out[0].device)
            busy += time.perf_counter() - t0
            saved[i] = (leaves, out)
            if s < S - 1:
                for x in out:
                    pmesh.send(x.detach(), ranks[s + 1])
            else:
                outs.append(tuple(x.detach() for x in out))
        PIPE_STATS.update(wall_s=time.perf_counter() - t_start, busy_s=busy,
                          ticks=M + S - 1, stage_ticks=M)
        if s == S - 1:
            result = tuple(torch.cat([o[k] for o in outs])
                           for k in range(n_carry))
        else:
            result = tuple(torch.empty_like(x) for x in carry)
        group = run["group"]
        if group is not None:
            for x in result:
                pmesh.broadcast(x, ranks[S - 1], group)
        ctx.run, ctx.saved_ticks, ctx.n_carry = run, saved, n_carry
        ctx.params = params
        return result

    @staticmethod
    def backward(ctx, *grads):
        run, saved, n_carry = ctx.run, ctx.saved_ticks, ctx.n_carry
        S, s, M = run["S"], run["s"], run["M"]
        ranks, params = run["ranks"], ctx.params
        pgrads = [None] * len(params)
        first = next(iter(saved.values()))[0]
        micro_grads: List[tuple] = [()] * M
        for t in reversed(range(M + S - 1)):
            i = t - s
            if not 0 <= i < M:
                continue
            leaves, out = saved[i]
            if s == S - 1:
                gy = tuple(None if g is None else
                           g[i * g.shape[0] // M:(i + 1) * g.shape[0] // M]
                           for g in grads)
            else:
                gy = tuple(pmesh.recv(x, ranks[s + 1]) for x in out)
            pairs = [(o, g) for o, g in zip(out, gy)
                     if o.requires_grad and g is not None]
            wrt = [x for x in leaves if x.requires_grad] + list(params)
            got = torch.autograd.grad([o for o, _ in pairs],
                                      wrt, [g for _, g in pairs],
                                      allow_unused=True)
            n_in = len(wrt) - len(params)
            it = iter(got[:n_in])
            gin = tuple(next(it) if x.requires_grad else None
                        for x in leaves)
            gin = tuple(torch.zeros_like(x) if g is None else g
                        for x, g in zip(leaves, gin))
            for k, g in enumerate(got[n_in:]):
                if g is not None:
                    pgrads[k] = g if pgrads[k] is None else pgrads[k] + g
            if s > 0:
                for g in gin:
                    pmesh.send(g.contiguous(), ranks[s - 1])
            else:
                micro_grads[i] = gin
        if s == 0:
            carry_grads = tuple(torch.cat([m[k] for m in micro_grads])
                                for k in range(n_carry))
        else:
            carry_grads = tuple(
                torch.empty((x.shape[0] * M,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
                for x in first)
        if run["group"] is not None:
            for g in carry_grads:
                pmesh.broadcast(g, ranks[0], run["group"])
        return (None, None) + carry_grads + tuple(pgrads)


def pipeline_apply(layer_fn: Callable[[nn.Module, tuple], tuple],
                   stage_layers: nn.ModuleList, carry: Sequence[torch.Tensor],
                   *, mesh: pmesh.Mesh, n_micro: int,
                   pipe_axis: str = "pipe") -> tuple:
    """Run `carry` (a tuple of (B, ...) tensors, this data rank's local
    batch) through all L layers of the pipeline, this rank applying its
    stage's `stage_layers`. `layer_fn(layer, carry) -> carry` applies one
    layer and must keep the carry's shapes (the attention bias rides
    along with its microbatch). B must divide into `n_micro`
    microbatches. Returns the final carry on every rank of the pipe
    group, equal to the L layers applied in sequence."""
    carry = tuple(carry)
    B = carry[0].shape[0]
    if B % n_micro:
        raise ValueError(f"local batch {B} does not divide into {n_micro} "
                         "microbatches")

    def stage(c):
        for layer in stage_layers:
            c = layer_fn(layer, c)
        return tuple(c)

    run = {"S": mesh.size(pipe_axis), "s": mesh.index(pipe_axis),
           "M": n_micro, "ranks": mesh.ranks(pipe_axis),
           "group": mesh.group(pipe_axis), "stage": stage}
    params = [p for p in stage_layers.parameters()]
    return _Pipeline.apply(run, len(carry), *carry, *params)
