"""Int8 serving quantization (port of xlxmert_tpu/ops/quant.py).

Scheme: per-output-channel symmetric int8 weights, per-row dynamic or
calibrated per-tensor static activation scales, int32 accumulation,
fp32 dequantization, bf16 out.

`QuantWeight` is an `nn.Module` holding the quantized weight as buffers,
in nn.Linear's (out, in) layout: `w_i8` (N, K) int8 is the transpose of
the reference's (K, N). Its forward runs the int8 dense kernel
(ops/int8_matmul.py) in dynamic mode, or in static mode once
`with_activation_scale` gave it a calibrated scale; while a calibration
observes it, it records the amax of its input.

`quantize_rows`, `int8_matmul` and `quantize_static` are the plain
arithmetic of the reference, used by the kernel's plain version and by
the tests. The dynamic quantization divides by the row scale as the
reference's engine path does (ops/quant.py:56); the TPU's fused kernel
multiplies by its reciprocal instead, which can move a value at a .5
boundary by one int8 step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


class AmaxObserver(nn.Module):
    """A calibration site: records max |x| over the calls it sees
    between `start_observing` and `stop_observing` (kept on the device
    until the end, so a calibration forward does not synchronise)."""

    def __init__(self):
        super().__init__()
        self.amax: Optional[float] = None
        self._observing = False
        self._running: Optional[torch.Tensor] = None

    def start_observing(self) -> None:
        self._observing, self._running = True, None

    def stop_observing(self) -> Optional[torch.Tensor]:
        """Ends the observation and returns the running amax (a 0-d
        tensor on the input's device, or None if never called)."""
        self._observing = False
        running, self._running = self._running, None
        return running

    def observe(self, x: torch.Tensor) -> None:
        if self._observing:
            a = x.detach().abs().amax().float()
            self._running = (a if self._running is None
                             else torch.maximum(self._running, a))


class QuantWeight(AmaxObserver):
    """Quantized dense weight: `w_i8` (N, K) int8, `scale` (N,) fp32,
    `bias` (N,) fp32 or None. After calibration `inv_a` (float32 value
    of 1/a_scale) and `out_scale` (N,) fp32 select the static path."""

    def __init__(self, w_i8: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_i8", w_i8)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        self.register_buffer("out_scale", None)
        self.inv_a: Optional[float] = None

    @property
    def calibrated(self) -> bool:
        return self.inv_a is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.observe(x)
        if self.inv_a is not None:
            return int8_dense_static(x, self)
        return int8_dense(x, self)


def quantize_weight(w: np.ndarray,
                    bias: Optional[np.ndarray] = None) -> QuantWeight:
    """(K, N) float weight -> QuantWeight on the CPU, bytes identical to
    the reference's (numpy, same operations)."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.maximum(scale, 1e-8)
    w_i8 = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return QuantWeight(
        torch.from_numpy(np.ascontiguousarray(w_i8.T)),
        torch.from_numpy(scale.astype(np.float32)),
        None if bias is None else torch.from_numpy(
            np.asarray(bias, np.float32).copy()))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) -> (int8 tensor, per-row fp32 scale (..., 1)).

    amax / 127 is a true division, as in the reference: the divisor is a
    tensor on x's device because PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can differ in the last
    bit. It is filled on the device (torch.full), not copied from the
    host, so that the call does not wait for the card."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1, keepdim=True)
                        / torch.full((), 127.0, device=xf.device), 1e-8)
    return torch.round(xf / s).to(torch.int8), s


def int8_accumulate(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of x_i8 (..., K) and w_i8 (N, K)^T. Computed
    in float64, which holds every sum exactly (|acc| < K * 127^2 << 2^53);
    float32 would not at K >= 2048, and CUDA has no integer matmul."""
    return (x_i8.double() @ w_i8.double().T).to(torch.int32)


def int8_matmul(x_i8: torch.Tensor, s_x: torch.Tensor, qw: QuantWeight,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., K) int8 @ QuantWeight -> (..., N) dequantized."""
    out = int8_accumulate(x_i8, qw.w_i8).float() * s_x * qw.scale
    if qw.bias is not None:
        out = out + qw.bias
    return out.to(out_dtype)


def quantize_static_values(x: torch.Tensor, inv: float) -> torch.Tensor:
    """clip(round(x * inv), -127, 127) as int8 (one multiply+round)."""
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(
        torch.int8)


def int8_dense(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """Dynamic per-row int8 dense through the int8 dense kernel."""
    from xlxmert_tpu_torch.ops.int8_matmul import int8_dense_fused

    return int8_dense_fused(x, qw.w_i8, qw.scale, qw.bias)


def int8_dense_static(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """Static-scale int8 dense through the int8 dense kernel: the quant
    is one multiply+round+clip, the dequant one multiply."""
    from xlxmert_tpu_torch.ops.int8_matmul import int8_dense_fused

    return int8_dense_fused(x, qw.w_i8, qw.out_scale, qw.bias,
                            inv_a=qw.inv_a)


def with_activation_scale(qw: QuantWeight, a_max: float) -> QuantWeight:
    """Attach a calibrated per-tensor activation scale, in place: the
    same float arithmetic as the reference (a Python-float a_scale, a
    float32 inv_a, out_scale = float32 scale * a_scale in numpy)."""
    a_scale = max(float(a_max), 1e-8) / 127.0
    qw.inv_a = float(np.float32(1.0 / a_scale))
    qw.out_scale = torch.from_numpy(
        np.asarray(qw.scale.cpu().numpy() * a_scale, np.float32)
    ).to(qw.scale.device)
    return qw


class ActScale(AmaxObserver):
    """Calibrated static scale for a weightless int8 site (the attention
    score/context inputs). `inv` (127/amax) and `scale` (amax/127) are
    float32 values set by `with_act_scale`."""

    def __init__(self):
        super().__init__()
        self.inv: Optional[float] = None
        self.scale: Optional[float] = None

    @property
    def calibrated(self) -> bool:
        return self.inv is not None


def make_act_scale() -> ActScale:
    return ActScale()


def with_act_scale(s: ActScale, a_max: float) -> ActScale:
    a = max(float(a_max), 1e-8) / 127.0
    s.inv, s.scale = float(np.float32(1.0 / a)), float(np.float32(a))
    return s


def quantize_static(x: torch.Tensor, s: ActScale) -> torch.Tensor:
    """bf16/fp32 -> int8 with a calibrated per-tensor scale."""
    return quantize_static_values(x, s.inv)
