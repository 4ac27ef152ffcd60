"""Fused FFN block: LN(W2 gelu(W1 x + b1) + b2 + x), forward only.

Port of `xlxmert_tpu/ops/ffn.py::fused_ffn`, the serving-mode
Intermediate -> FFOutput pair of models/lxmert.py in one kernel: the
(rows, intermediate) activation never reaches device memory. The CUDA
kernel is `xlxmert_tpu_torch/csrc/fused_ffn.cu` (its header says what
bounds it on an H100 and what the design does about it);
`fused_ffn_reference` is the same function in plain PyTorch.

Rounding points, as the TPU kernel's: x W1 accumulated in fp32, + b1 in
fp32; gelu in fp32, cast to x's dtype; times W2 accumulated in fp32,
+ b2, + x in fp32; two-pass LayerNorm statistics in fp32 (the mean,
then the mean of (y - mu)^2); rsqrt, times g, + beta, cast to x's dtype.
b1, b2, g and beta enter as fp32 rows; the weights are cast to x's
dtype.

Weights are in nn.Linear's layout, as the port's modules hold them:
w1 (I, H) is Intermediate's dense weight, w2 (H, I) FFOutput's.

`fused_ffn` takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises. It is forward only, as
the JAX package's (no vjp): a backward through its result raises on
every device (`ops/_grad.forward_only`); `fused_ffn_reference` stays
differentiable.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from xlxmert_tpu_torch.ops._build import Kernel
from xlxmert_tpu_torch.ops._grad import forward_only
from xlxmert_tpu_torch.ops._plan import launch_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("fused_ffn", "fused_ffn.cu",
                [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I,
                 _I, _P])

HIDDEN = 768      # the kernel's row width (every LXMERT configuration)
CHUNK = 64        # the kernel takes an intermediate in multiples of this
_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi).astype(np.float32))
_SQRT_HALF = float(np.sqrt(0.5).astype(np.float32))


def gelu_f32(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    """jax.nn.gelu on fp32, in its order of operations: the tanh form
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))), or the exact
    0.5 * x * erfc(-x * sqrt(1/2))."""
    if approximate:
        inner = _SQRT_2_OVER_PI * (h + 0.044715 * (h * h * h))
        return h * (0.5 * (1.0 + torch.tanh(inner)))
    return 0.5 * h * torch.special.erfc(-h * _SQRT_HALF)


def fused_ffn_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                        approx_gelu: bool = True,
                        eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float().t() + b1.float()
    h = gelu_f32(h, approx_gelu).to(dt)
    y = h.float() @ w2.to(dt).float().t() + b2.float()
    y = y + x.float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps)
    out = out * ln_scale.float() + ln_bias.float()
    return out.to(dt)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"fused_ffn: {name} must be a contiguous, 16-byte aligned "
            f"{dtype} tensor of shape {shape} on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, ln_scale: torch.Tensor,
              ln_bias: torch.Tensor, approx_gelu: bool = True,
              eps: float = 1e-12) -> torch.Tensor:
    """x (..., H) -> LN(W2 gelu(W1 x + b1) + b2 + x), (..., H) in x's
    dtype; w1 (I, H), w2 (H, I). Leading dims are rows. The kernel takes
    bf16 x, H = 768 and I a multiple of 64. Forward only: a backward
    through the result raises."""
    return forward_only(
        "fused_ffn has no gradient: the JAX package's fused_ffn has no vjp "
        "(differentiate fused_ffn_reference)", _fused_ffn_forward, x, w1,
        b1, w2, b2, ln_scale, ln_bias, approx_gelu, eps)


def _fused_ffn_forward(x, w1, b1, w2, b2, ln_scale, ln_bias,
                       approx_gelu: bool, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_ffn_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                                   approx_gelu, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    I, H = w1.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_ffn: the kernel takes bf16 rows, got "
                         f"{x.dtype}")
    if H != HIDDEN or x.shape[-1] != H or I % CHUNK:
        raise ValueError(f"fused_ffn: the kernel takes x (..., {HIDDEN}) "
                         f"and w1 (I, {HIDDEN}) with I a multiple of "
                         f"{CHUNK}; got x {tuple(x.shape)}, w1 ({I}, {H})")
    if not x.is_contiguous():
        raise ValueError("fused_ffn: x must be contiguous")
    dev = x.device
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    b1, b2, g, be = (t.float() for t in (b1, b2, ln_scale, ln_bias))
    x2 = x.reshape(-1, H)
    M = x2.shape[0]
    _check(x2, "x", torch.bfloat16, (M, H), dev)
    _check(w1, "w1", torch.bfloat16, (I, H), dev)
    _check(w2, "w2", torch.bfloat16, (H, I), dev)
    _check(b1, "b1", torch.float32, (I,), dev)
    for t, name in ((b2, "b2"), (g, "ln_scale"), (be, "ln_bias")):
        _check(t, name, torch.float32, (H,), dev)
    out = torch.empty_like(x2)
    if M:
        KERNEL.launch(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), g.data_ptr(), be.data_ptr(), out.data_ptr(), M,
            I, float(eps), int(bool(approx_gelu)), launch_plan(M, I),
            torch.cuda.current_stream(dev).cuda_stream)
    return out.reshape(x.shape)
