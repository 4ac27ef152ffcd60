"""Int8 attention with calibrated static scales: the port of
`xlxmert_tpu/serving/lxmert_int8.py::_attention_core_int8`.

q, k and v (B, L, H*D) are quantized with their sites' calibrated
per-tensor scales; the scores q8 . k8^T are exact int32 products; the
softmax runs in fp32 on the dequantized scores plus the key bias; the
probabilities quantize with the fixed scale 1/127 (their amax is 1 by
construction); the context p8 . v8 is an exact int32 product,
dequantized and cast to bf16:

    q8 = clip(round(f32(q) * q_inv), -127, 127)   (likewise k8, v8)
    s  = f32(q8 . k8^T) * c_s + f32(bias),  c_s = f32(f32(qs * ks) / sqrt(D))
    p8 = round(softmax(s) * 127)
    ctx = bf16(f32(p8 . v8) * c_v),          c_v = f32(vs / 127)

with rounding half to even. The scales are float32 values kept as
Python floats (ops/quant.ActScale); c_s and c_v are formed in float32
in the JAX package's order (a float64 product would differ from JAX's
in the last bit at some D).

`mha_int8` launches the hand-written kernel `csrc/mha_int8.cu` (bf16
q/k/v, D = 64, lengths up to 64, a bf16 key bias) for CUDA tensors and
takes the plain version `mha_int8_reference` for CPU tensors; on the
card there is no fallback. It is forward only, as the JAX function
(serving code) is never differentiated. The plain version computes the
two products in fp32 with TF32 off: every sum is an integer below
64 * 127 * 127 < 2^24, so it is exact.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from xlxmert_tpu_torch.ops._build import Kernel
from xlxmert_tpu_torch.ops._grad import forward_only
from xlxmert_tpu_torch.ops.attention import (
    HEAD_DIM, MAX_LEN, _check_operand, _heads,
)
from xlxmert_tpu_torch.ops.quant import quantize_static_values

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# q, k, v, bias, out, B, H, Lq, Lk, the q/k/v batch and row strides,
# q_inv, k_inv, v_inv, c_s, c_v, stream
KERNEL = Kernel("mha_int8", "mha_int8.cu",
                [_P] * 5 + [_I] * 4 + [_LL] * 6 + [_F] * 5 + [_P])


def score_scale(q_scale: float, k_scale: float, head_dim: int) -> float:
    """c_s as JAX forms it: f32(f32(qs) * f32(ks)) / f32(sqrt(D))."""
    f32 = np.float32
    return float(f32(f32(q_scale) * f32(k_scale)) / f32(np.sqrt(head_dim)))


def context_scale(v_scale: float) -> float:
    """c_v = f32(vs) / 127 in float32."""
    return float(np.float32(v_scale) / np.float32(127.0))


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for the plain version's fp32 products on the card."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def mha_int8_reference(q, k, v, bias, n_heads: int, inv: Sequence[float],
                       scale: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX function's
    arithmetic): q (B, Lq, H*D), k/v (B, Lk, H*D), bias (B, 1, 1, Lk) or
    (B, Lk) or None, `inv` and `scale` the (q, k, v) sites' calibrated
    float32 values. Returns (B, Lq, H*D) bf16."""
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    D = HD // n_heads
    q8, k8, v8 = (_heads(quantize_static_values(t, s), n_heads)
                  for t, s in zip((q, k, v), inv))
    with _tf32_off():
        s = q8.float() @ k8.float().transpose(-1, -2)
        s = s * score_scale(scale[0], scale[1], D)
        if bias is not None:
            s = s + bias.reshape(B, 1, 1, Lk).float()
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p8 = torch.round(e / e.sum(-1, keepdim=True) * 127.0)
        ctx = (p8 @ v8.float()) * context_scale(scale[2])
    return ctx.to(torch.bfloat16).transpose(1, 2).reshape(B, Lq, HD)


def mha_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor], n_heads: int,
             inv: Sequence[float], scale: Sequence[float]) -> torch.Tensor:
    """Int8 attention over packed heads; see the module docstring. On the
    card q, k and v are bf16 column slices of the fused projections (unit
    column stride, 16-byte aligned rows), D = 64, lengths up to 64, the
    bias a contiguous bf16 (B, Lk) or (B, 1, 1, Lk). Forward only: a
    backward through the result raises."""
    return forward_only(
        "mha_int8 has no gradient: the JAX package's int8 attention is "
        "serving code and is never differentiated", _mha_int8_forward, q,
        k, v, bias, n_heads, tuple(inv), tuple(scale))


def _mha_int8_forward(q, k, v, bias, n_heads: int, inv, scale):
    if q.device.type == "cpu":
        return mha_int8_reference(q, k, v, bias, n_heads, inv, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_int8: unsupported device {q.device}")
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    D = HD // n_heads
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"mha_int8: q/k/v must be bf16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if D * n_heads != HD or D != HEAD_DIM:
        raise ValueError(f"mha_int8: head dim {HD}/{n_heads} is not "
                         f"{HEAD_DIM}")
    if not (1 <= Lq <= MAX_LEN and 1 <= Lk <= MAX_LEN) or v.shape[1] != Lk:
        raise ValueError(f"mha_int8: lengths ({Lq}, {Lk}, {v.shape[1]}) "
                         f"must be at most {MAX_LEN}, k and v alike")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"mha_int8: {name} is on {t.device}")
        _check_operand(t, name, B, HD, 8, "mha_int8")
    if bias is not None and (
            bias.dtype != torch.bfloat16 or bias.device != q.device
            or bias.numel() != B * Lk or not bias.is_contiguous()):
        raise ValueError(f"mha_int8: bias must be a contiguous bf16 (B, Lk) "
                         f"or (B, 1, 1, Lk) tensor on {q.device}")
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    KERNEL.launch(*launch_args(q, k, v, bias, out, n_heads, inv, scale))
    return out


def launch_args(q, k, v, bias, out, n_heads: int, inv, scale) -> tuple:
    """`mha_int8_launch`'s arguments for checked operands, on the current
    stream."""
    B, Lq, HD = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), B,
            n_heads, Lq, k.shape[1], q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1),
            *(float(np.float32(x)) for x in inv),
            score_scale(scale[0], scale[1], HD // n_heads),
            context_scale(scale[2]),
            torch.cuda.current_stream(q.device).cuda_stream)
