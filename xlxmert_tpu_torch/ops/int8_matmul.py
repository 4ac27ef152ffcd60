"""Int8 dense kernel wrapper and its plain version.

Port of `xlxmert_tpu/ops/int8_matmul.py::int8_dense_fused`: activation
quantization, int8 x int8 -> int32 product, dequantization and bias in
one kernel (`xlxmert_tpu_torch/csrc/int8_dense.cu`; its header says what
bounds it on an H100 and what the design does about it). The same
kernel also carries the static-scale dense (`inv_a`, `out_scale`), which
is every dense of the serving path after calibration.

`int8_dense_fused` takes the plain version, `int8_dense_reference`, only
for tensors on the CPU. For CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from xlxmert_tpu_torch.ops._build import Kernel
from xlxmert_tpu_torch.ops.quant import (
    int8_accumulate, quantize_rows, quantize_static_values,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("int8_dense", "int8_dense.cu",
                [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P])


def int8_dense_reference(x: torch.Tensor, w_i8: torch.Tensor,
                         col_scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         inv_a: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version. Dynamic (inv_a None): per-row scales,
    col_scale is the weight scale. Static: clip(round(x * inv_a)),
    col_scale is out_scale. The int32 product is exact (float64)."""
    if inv_a is None:
        x_i8, s = quantize_rows(x)
        out = int8_accumulate(x_i8, w_i8).float() * s * col_scale
    else:
        out = int8_accumulate(quantize_static_values(x, inv_a),
                              w_i8).float() * col_scale
    if bias is not None:
        out = out + bias
    return out.to(torch.bfloat16)


def _check(t: Optional[torch.Tensor], name: str, dtype, shape, device):
    if t is None:
        return
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"int8_dense: {name} must be a contiguous, 16-byte aligned "
            f"{dtype} tensor of shape {shape} on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def int8_dense_fused(x: torch.Tensor, w_i8: torch.Tensor,
                     col_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     inv_a: Optional[float] = None) -> torch.Tensor:
    """x (..., K) -> (..., N) bf16 with w_i8 (N, K) int8; see
    int8_dense_reference for the modes. Leading dims are rows."""
    if x.device.type == "cpu":
        return int8_dense_reference(x, w_i8, col_scale, bias, inv_a)
    if x.device.type != "cuda":
        raise ValueError(f"int8_dense: unsupported device {x.device}")
    if col_scale is None:
        raise ValueError("int8_dense: static mode needs out_scale")
    N, K = w_i8.shape
    lead = x.shape[:-1]
    if x.shape[-1] != K or K % 16:
        raise ValueError(f"int8_dense: x (..., {x.shape[-1]}) against w "
                         f"({N}, {K}); K must match and be a multiple of 16")
    if not x.is_contiguous():
        raise ValueError("int8_dense: x must be contiguous")
    x2 = x.reshape(-1, K)
    _check(x2, "x", torch.bfloat16, tuple(x2.shape), x.device)
    _check(w_i8, "w_i8", torch.int8, (N, K), x.device)
    _check(col_scale, "col_scale", torch.float32, (N,), x.device)
    _check(bias, "bias", torch.float32, (N,), x.device)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M:
        KERNEL.launch(
            x2.data_ptr(), w_i8.data_ptr(),
            col_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, N, K, 0.0 if inv_a is None else inv_a,
            int(inv_a is None), torch.cuda.current_stream(x.device).cuda_stream)
    return out.reshape(*lead, N)
