"""Whole-block fused int8 chain of one encoder module, forward only.

Port of `xlxmert_tpu/ops/fused_block.py`: one kernel runs the densest
serial chain of an encoder layer over a block of rows,

    quant -> out-projection (int8) -> + residual -> LayerNorm
          -> [quant -> FFN1 (int8) -> gelu -> quant -> FFN2 (int8)
              -> + residual -> LayerNorm]
          -> [quant -> the next module's QKV or cross q|kv (int8)]

with every intermediate, the 3,072-wide FFN activation included, kept
out of device memory. The CUDA kernel is
`xlxmert_tpu_torch/csrc/fused_block.cu` (its header says what bounds it
on an H100 and what the design does about it); `fused_block_reference`
is the same chain in plain PyTorch, composed from the int8 engine's own
operations in the engine's order, so on the CPU it gives the engine's
bits.

Numerics are the static int8 engine's (serving/lxmert_int8.py): each
product quantizes its input with a calibrated per-tensor scale, sums in
int32 and dequantizes as acc * out_scale + bias in fp32, rounded to
bf16; residual adds are bf16; LayerNorm takes fp32 two-pass statistics
and rounds to bf16; tanh gelu runs on the bf16 FFN1 output and rounds to
bf16 before it is quantized.

`fused_block` takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel once per call or raises.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.ops._build import Kernel
from xlxmert_tpu_torch.ops._plan import launch_plan
from xlxmert_tpu_torch.ops.int8_matmul import int8_dense_reference
from xlxmert_tpu_torch.ops.quant import QuantWeight
from xlxmert_tpu_torch.serving.lxmert_int8 import layer_norm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("fused_block", "fused_block.cu",
                [_P] * 20 + [_I] * 3 + [_F] * 5 + [_I, _P])

HIDDEN = 768      # the kernel's row width (every LXMERT configuration)
TILE = 128        # the FFN and tail widths are taken in tiles of this width
EPS = 1e-12


class FusedWeight(nn.Module):
    """A calibrated int8 weight in the form the kernel takes: `w_i8`
    (N, K) int8 (nn.Linear's layout, as `QuantWeight`), `out_scale`
    (1, N) fp32 (activation scale x column scale), `bias` (1, N) fp32
    and `inv_a`, the Python float of the static input scale 127/amax."""

    def __init__(self, w_i8: torch.Tensor, out_scale: torch.Tensor,
                 bias: torch.Tensor, inv_a: float):
        super().__init__()
        self.register_buffer("w_i8", w_i8)
        self.register_buffer("out_scale", out_scale)
        self.register_buffer("bias", bias)
        self.inv_a = inv_a


def fused_weight(qw: QuantWeight) -> FusedWeight:
    """Calibrated QuantWeight -> FusedWeight, sharing its tensors."""
    if qw.inv_a is None:
        raise ValueError("fused_weight: the weight is not calibrated "
                         "(calibrate, then apply_calibration first)")
    n = qw.w_i8.shape[0]
    bias = (qw.bias if qw.bias is not None
            else torch.zeros(n, device=qw.w_i8.device))
    return FusedWeight(qw.w_i8, qw.out_scale.reshape(1, n).float(),
                       bias.reshape(1, n).float(), float(qw.inv_a))


def concat_fused(a: QuantWeight, b: QuantWeight) -> FusedWeight:
    """Two calibrated weights that consume the same activation (the
    cross-attention q and kv) as one (Na + Nb, K) product. Their static
    input scales must be equal."""
    fa, fb = fused_weight(a), fused_weight(b)
    if fa.inv_a != fb.inv_a:
        raise ValueError(f"concat_fused: the two weights' input scales "
                         f"differ ({fa.inv_a} != {fb.inv_a})")
    return FusedWeight(torch.cat([fa.w_i8, fb.w_i8], 0),
                       torch.cat([fa.out_scale, fb.out_scale], 1),
                       torch.cat([fa.bias, fb.bias], 1), fa.inv_a)


def plain_dense(x: torch.Tensor, fw: FusedWeight) -> torch.Tensor:
    """The static int8 dense of the engine, plain (int8_dense_reference):
    clip(round(x * inv_a)) -> exact int32 product -> acc * out_scale +
    bias -> bf16."""
    return int8_dense_reference(x, fw.w_i8, fw.out_scale, fw.bias,
                                fw.inv_a)


class LN(NamedTuple):
    """LayerNorm parameters (the fields of serving/lxmert_int8.LayerNorm)."""
    scale: torch.Tensor
    bias: torch.Tensor


def fused_block_reference(ctx, x, out_w: FusedWeight, ln1,
                          w1: Optional[FusedWeight] = None,
                          w2: Optional[FusedWeight] = None, ln2=None,
                          tail_w: Optional[FusedWeight] = None, *,
                          dense: Callable = plain_dense):
    """Plain PyTorch version of the kernel: the engine's operations in
    the engine's order. ln1 / ln2 have `.scale` and `.bias` (a LayerNorm
    module or `LN`); the FFN runs when w1 is given. Returns y, or
    (y, tail) with tail_w. `dense` is the int8 dense it runs (plain by
    default; chip_smoke.py times the same chain with the int8 dense
    kernel and with torch._int_mm)."""
    y = layer_norm(dense(ctx, out_w) + x, ln1, EPS)
    if w1 is not None:
        h = F.gelu(dense(y, w1), approximate="tanh")
        y = layer_norm(dense(h, w2) + y, ln2, EPS)
    if tail_w is None:
        return y
    return y, dense(y, tail_w)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(
            f"fused_block: {name} must be a contiguous, 16-byte aligned "
            f"{dtype} tensor of shape {tuple(shape)} on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_weight(fw: FusedWeight, name: str, n: int, k: int, device):
    if n % TILE:
        raise ValueError(f"fused_block: {name} has {n} output columns; "
                         f"the kernel takes a multiple of {TILE}")
    _check(fw.w_i8, f"{name}.w_i8", torch.int8, (n, k), device)
    _check(fw.out_scale, f"{name}.out_scale", torch.float32, (1, n), device)
    _check(fw.bias, f"{name}.bias", torch.float32, (1, n), device)


def fused_block(ctx: torch.Tensor, x: torch.Tensor, out_w: FusedWeight,
                ln1_g: torch.Tensor, ln1_b: torch.Tensor,
                w1: Optional[FusedWeight] = None,
                w2: Optional[FusedWeight] = None,
                ln2_g: Optional[torch.Tensor] = None,
                ln2_b: Optional[torch.Tensor] = None,
                tail_w: Optional[FusedWeight] = None,
                has_ffn: bool = True):
    """Run the fused chain over rows; the JAX wrapper's signature without
    its `block_rows`, a TPU VMEM knob: the kernel takes 64 rows a CTA in
    clusters of `ops/_plan.launch_plan`'s shape.

    ctx: (..., 768) attention context (before the out-projection), bf16.
    x:   (..., 768) residual (the module's input), bf16.
    Returns y (..., 768), or (y, tail) (..., Nq) when tail_w is given:
    the next module's projection. The kernel takes bf16 rows of 768,
    an intermediate and a tail width that are multiples of 128."""
    if has_ffn and any(t is None for t in (w1, w2, ln2_g, ln2_b)):
        raise ValueError("fused_block: has_ffn needs w1, w2, ln2_g, ln2_b")
    if not has_ffn:
        w1 = w2 = ln2_g = ln2_b = None
    if ctx.device.type == "cpu":
        return fused_block_reference(
            ctx, x, out_w, LN(ln1_g, ln1_b), w1, w2,
            None if w1 is None else LN(ln2_g, ln2_b), tail_w)
    if ctx.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {ctx.device}")
    H = ctx.shape[-1]
    if H != HIDDEN or x.shape != ctx.shape:
        raise ValueError(f"fused_block: the kernel takes ctx and x of one "
                         f"shape (..., {HIDDEN}); got {tuple(ctx.shape)} "
                         f"and {tuple(x.shape)}")
    if ctx.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"fused_block: the kernel takes bf16 rows; got "
                         f"{ctx.dtype} and {x.dtype}")
    if not (ctx.is_contiguous() and x.is_contiguous()):
        raise ValueError("fused_block: ctx and x must be contiguous")
    dev, lead = ctx.device, ctx.shape[:-1]
    c2, x2 = ctx.reshape(-1, H), x.reshape(-1, H)
    M = c2.shape[0]
    _check(c2, "ctx", torch.bfloat16, (M, H), dev)
    _check(x2, "x", torch.bfloat16, (M, H), dev)
    _check_weight(out_w, "out_w", H, H, dev)
    vecs = [ln1_g, ln1_b]
    I = Nq = 0
    if w1 is not None:
        I = w1.w_i8.shape[0]
        _check_weight(w1, "w1", I, H, dev)
        _check_weight(w2, "w2", H, I, dev)
        vecs += [ln2_g, ln2_b]
    for i, t in enumerate(vecs):
        _check(t, f"LayerNorm vector {i}", torch.float32, (H,), dev)
    if tail_w is not None:
        Nq = tail_w.w_i8.shape[0]
        _check_weight(tail_w, "tail_w", Nq, H, dev)
    y = torch.empty((M, H), dtype=torch.bfloat16, device=dev)
    tail = (None if tail_w is None else
            torch.empty((M, Nq), dtype=torch.bfloat16, device=dev))

    def ptrs(fw: Optional[FusedWeight]):
        if fw is None:
            return [None, None, None]
        return [fw.w_i8.data_ptr(), fw.out_scale.data_ptr(),
                fw.bias.data_ptr()]

    def inv(fw: Optional[FusedWeight]) -> float:
        return 1.0 if fw is None else fw.inv_a

    if M:
        ln2 = [None, None] if w1 is None else [ln2_g.data_ptr(),
                                                ln2_b.data_ptr()]
        KERNEL.launch(
            c2.data_ptr(), x2.data_ptr(), *ptrs(out_w), ln1_g.data_ptr(),
            ln1_b.data_ptr(), *ptrs(w1), *ptrs(w2), *ln2, *ptrs(tail_w),
            y.data_ptr(), None if tail is None else tail.data_ptr(), M, I,
            Nq, out_w.inv_a, inv(w1), inv(w2), inv(tail_w), EPS,
            launch_plan(M, I), torch.cuda.current_stream(dev).cuda_stream)
    y = y.reshape(*lead, H)
    if tail is None:
        return y
    return y, tail.reshape(*lead, Nq)
