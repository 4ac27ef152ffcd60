"""The reference's "BERT-Adam" (port of xlxmert_tpu/core/optim.py):
legacy transformers AdamW + linear warmup/decay with no-decay parameter
groups (lxmert_pretrain.py:110-141), as a functional update over named
fp32 parameters.

The update is the JAX package's, op for op in fp32:
  - eps is added to the UNCORRECTED sqrt(v), not to the bias-corrected
    one: upd = -lr_t * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps);
  - step counts are per parameter (torch's state["step"]); the
    fine-tuning engine advances every one on every update;
  - weight decay is applied to the already-updated parameter:
    p_new = (p + upd) * (1 - lr_t * wd), written as a delta;
  - clipping is torch's clip_grad_norm_: scale = max_norm / (norm +
    1e-6), applied only when the global norm exceeds max_norm;
  - the schedule (`linear_warmup_decay`, optax's linear schedules
    joined at the warmup boundary) steps once per update.

No decay for every bias and every LayerNorm parameter, decided on the
parameter's flax path (`no_decay`), as the JAX package decides: the
leaf is `bias`, `scale` (a 1-D `weight` converts to it) or
`out_cluster_bias`, or a path element is `LayerNorm`. So
`visn_layer_norm.weight`, `box_layer_norm.weight` and the answer head's
`logit_fc.2.weight` are exempt, which the reference's torch substring
rule "LayerNorm.weight" would decay.

Parameters are updated in place (`torch.no_grad`), which saves a copy
of the model per update; the JAX package returns new arrays.

`Adam` is the GAN trainer's `optax.adam(lr, b1, b2, eps)`
(tasks/train_generator.py): one step count for the whole tree, bias
correction of both moments with count + 1, eps added outside the square
root of the corrected second moment, no weight decay, no clipping.
"""
from __future__ import annotations

from typing import AbstractSet, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from xlxmert_tpu_torch.core.convert import _fold_indices


def linear_warmup_decay(lr: float, total_steps: int,
                        warmup_ratio: float = 0.05
                        ) -> Callable[[int], np.float32]:
    """optax.join_schedules of linear 0 -> lr over the warmup steps and
    lr -> 0 over the rest, in float32 as the JAX package's jitted step
    evaluates it: XLA multiplies by the reciprocal of the step count and
    fuses each multiply-add (one rounding, emulated here in float64)."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps - warmup, 1)
    f32 = np.float32

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        frac = f32(1.0 - count * float(f32(1) / f32(steps)))
        return f32(float(f32(init - end)) * float(frac) + float(f32(end)))

    def schedule(step: int) -> np.float32:
        if step < warmup:
            return linear(0.0, lr, warmup, step)
        return linear(lr, 0.0, decay, step - warmup)

    return schedule


def no_decay(name: str, ndim: int) -> bool:
    """The JAX package's no-decay rule on the parameter's flax path (the
    path `core/convert.convert_torch_state_dict` gives it)."""
    path = list(_fold_indices(name))
    if path[-1] == "weight" and ndim == 1:
        path[-1] = "scale"
    return (path[-1] in ("bias", "scale", "out_cluster_bias")
            or "LayerNorm" in path[:-1])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm),
    an fp32 scalar tensor."""
    return torch.sqrt(torch.stack([torch.sum(t.float() * t.float())
                                   for t in tensors]).sum())


class ReferenceAdamW:
    """Legacy AdamW + linear schedule + torch grad clipping over the
    named parameters `params` ({name: fp32 tensor}, updated in place).

    `step(grads)` applies one update from {name: gradient} (every name
    of `params`; a missing or None gradient counts as zero, as the JAX
    package's dense gradient tree holds zeros for parameters the loss
    does not reach). `step(grads, used=names)` is the JAX package's
    `used_mask` (pre-training's per-task skip, torch's grad-is-None
    rule): a parameter outside `used` gets no update and keeps its `m`,
    `v` and `count`; the schedule still steps, and the clip norm is
    taken over the gradients given. `norm` ({name: gradient} -> the
    global norm) is replaced where parameters are sharded (a tensor-
    parallel run sums the shards' squares over the model group). State:
    per-parameter `count`, `m` and `v`, and the schedule position
    `sched_step`."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 total_steps: int, warmup_ratio: float = 0.05,
                 weight_decay: float = 0.01,
                 clip_grad_norm: Optional[float] = 1.0, eps: float = 1e-6,
                 b1: float = 0.9, b2: float = 0.999):
        self.params = params
        self.schedule = linear_warmup_decay(lr, total_steps, warmup_ratio)
        self.weight_decay, self.clip_grad_norm = weight_decay, clip_grad_norm
        self.eps, self.b1, self.b2 = eps, b1, b2
        self.decay = {n: not no_decay(n, p.dim()) for n, p in params.items()}
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = {n: 0 for n in params}
        self.sched_step = 0
        self.norm: Callable[[Dict[str, torch.Tensor]], torch.Tensor] = \
            lambda grads: global_norm(grads.values())

    def lr(self) -> np.float32:
        """The learning rate of the next update."""
        return self.schedule(self.sched_step)

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]],
             used: Optional[AbstractSet[str]] = None) -> None:
        # scalars are float32 values (as JAX's weak-typed constants round
        # to the fp32 leaves' type) passed to torch as Python floats
        f32 = np.float32
        lr_t = self.lr()
        present = {n: g for n, g in grads.items() if g is not None}
        clip = None
        if self.clip_grad_norm and self.clip_grad_norm > 0 and present:
            norm = self.norm(present)
            clip = torch.clamp(float(f32(self.clip_grad_norm))
                               / (norm + float(f32(1e-6))), max=1.0)
        b1, b2 = f32(self.b1), f32(self.b2)
        c1, c2 = float(f32(1 - self.b1)), float(f32(1 - self.b2))
        wd = float(lr_t * f32(self.weight_decay))
        eps = float(f32(self.eps))
        for name, p in self.params.items():
            if used is not None and name not in used:
                continue
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            if clip is not None:
                g = g * clip
            m = float(b1) * self.m[name] + c1 * g
            v = float(b2) * self.v[name] + c2 * g * g
            self.count[name] += 1
            t = f32(self.count[name])
            step_scale = f32(np.sqrt(f32(1) - b2 ** t) / (f32(1) - b1 ** t))
            upd = float(f32(-lr_t) * step_scale) * m / (torch.sqrt(v) + eps)
            if self.decay[name] and self.weight_decay:
                upd = upd - wd * (p + upd)
            p.add_(upd)
            self.m[name], self.v[name] = m, v
        self.sched_step += 1


def make_optimizer(params: Dict[str, torch.Tensor], lr: float,
                   total_steps: int, warmup_ratio: float = 0.05,
                   weight_decay: float = 0.01,
                   clip_grad_norm: Optional[float] = 1.0,
                   adam_eps: float = 1e-6) -> ReferenceAdamW:
    return ReferenceAdamW(params, lr, total_steps, warmup_ratio,
                          weight_decay, clip_grad_norm, eps=adam_eps)


class Adam:
    """optax.adam(lr, b1, b2, eps) over the named parameters `params`
    ({name: fp32 tensor}, updated in place), op for op in fp32:
      mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t = count + 1;
      p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps).
    State: `count` (optax's ScaleByAdamState.count), `mu` and `nu`
    ({name: tensor}). A None gradient counts as zero, as the JAX
    package's dense gradient tree holds zeros."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        # scalars are the float32 values the jitted JAX update uses,
        # passed to torch as Python floats
        f32 = np.float32
        b1, b2 = f32(self.b1), f32(self.b2)
        t = f32(self.count + 1)
        c1 = float(f32(1) - b1 ** t)
        c2 = float(f32(1) - b2 ** t)
        a1, a2 = float(f32(1 - self.b1)), float(f32(1 - self.b2))
        neg_lr = float(f32(-self.lr))
        eps = float(f32(self.eps))
        for name, p in self.params.items():
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            mu = a1 * g + float(b1) * self.mu[name]
            nu = a2 * (g * g) + float(b2) * self.nu[name]
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + eps) * neg_lr)
            self.mu[name], self.nu[name] = mu, nu
        self.count += 1
