"""Forward-only kernels under autograd.

The JAX package gives `mha_blhd`, `fused_ffn` and the attention-layout
driver's `core_hbatch` no vjp, so `jax.grad` through them raises. The
port's wrappers of those kernels (`ops/attention.mha_blhd`,
`mha_hbatch`, `ops/ffn.fused_ffn`) refuse a backward the same way, on
every device: their forward runs as it is, and when grad is enabled and
an input requires grad its output carries a `grad_fn` whose backward
raises. Without that, a kernel's output on the card (a `torch.empty`
filled through ctypes) would have no history, and gradients through it
would be dropped without an error. A forward alone is not refused: a
model whose parameters require grad may run these kernels, as JAX
allows. Under `torch.no_grad()` or `torch.inference_mode()` the wrapper
is called directly and adds nothing.
"""
from __future__ import annotations

import torch


class _NoBackward(torch.autograd.Function):
    """Forward: `fn(*args)`. Backward: raises `message`."""

    @staticmethod
    def forward(ctx, message, fn, *args):
        ctx.message = message
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ctx.message)


def tracks_grad(*args) -> bool:
    """True when grad is enabled and a tensor in `args` requires grad:
    when autograd would record an operation on them."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def forward_only(message: str, fn, *args):
    """`fn(*args)`; its result's backward raises RuntimeError(message)
    when `tracks_grad(*args)`."""
    if tracks_grad(*args):
        return _NoBackward.apply(message, fn, *args)
    return fn(*args)
