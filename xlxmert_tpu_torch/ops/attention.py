"""Fused multi-head attention: two layouts, one kernel, and a training
variant with a dropout mask and a backward.

`mha_blhd` ports `xlxmert_tpu/ops/attention.py::mha_blhd`: q (B, Lq,
H*D), k/v (B, Lk, H*D), optional additive key bias (B, 1, 1, Lk) or
(B, Lk); the result is (B, Lq, H*D), the layout the out-projection
consumes, so no head is ever transposed in device memory.

`fused_mha` ports `xlxmert_tpu/ops/attention.py::fused_mha`: the same
function over (B, H, L, D) operands, with a (B, Lk) bias, returning
(B, H, Lq, D). Only the layout differs: head h sits at a head stride,
not at column h*D.

`mha_hbatch` ports the batched-head variant of `mha_blhd` that
`scripts/drive_attention_layout.py` measures (`core_hbatch`): the same
function as `mha_blhd(fast=True)`, organised as the TPU kernel is, the
heads of a batch row in one program (`csrc/mha_hbatch.cu`, its own
kernel and launch count, one CTA walking a row's heads through a ring in
shared memory by the plan of `ops/_plan.hbatch_plan`); each head runs
`mha_blhd`'s per-tile body, so the two agree bit for bit.

`mha_blhd_train` ports `xlxmert_tpu/ops/attention.py::mha_blhd_train`,
the training path's attention: `mha_blhd`'s function with a pre-scaled
dropout mask (B, H, Lq, Lk) applied to the probabilities, as a
`torch.autograd.Function`. Its forward is the kernel; its backward
recomputes `blhd_einsum_reference` with the same mask in plain PyTorch,
as the JAX package's custom_vjp recomputes its einsum outside Pallas.

The CUDA kernels: `csrc/mha_blhd.cu` and `csrc/fused_mha.cu` run bf16
inputs on tensor cores (`csrc/attention_mma.cuh`) and fp32 ones on CUDA
cores (`csrc/attention.cuh`); `csrc/mha_blhd_train.cu` is the CUDA-core
body with the mask as a template flag. Each header says what bounds it
on an H100 and what its design does about it; each library has its own
launch count. `mha_blhd_reference`, `fused_mha_reference` and
`mha_blhd_train_reference` are the same functions in plain PyTorch,
with the same rounding points.

Gradients, as in the JAX package: `fused_mha` is differentiable (its
backward recomputes `einsum_mha_reference`, as the JAX custom_vjp
recomputes `_einsum_mha`), and so is `mha_blhd_train`; `mha_blhd` and
`mha_hbatch` have no vjp in the JAX package and refuse a backward on
every device (`ops/_grad.forward_only`). The plain `*_reference`
functions stay differentiable.

The wrappers take the plain versions only for tensors on the CPU. For
CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from xlxmert_tpu_torch.ops._build import Kernel
from xlxmert_tpu_torch.ops._grad import forward_only, tracks_grad
from xlxmert_tpu_torch.ops._plan import hbatch_plan

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel("mha_blhd", "mha_blhd.cu",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
                 _LL, _LL, ctypes.c_float, _I, _I, _P])
# q/k/v batch, head and row strides (9 values), then scale, dtype, fast
FUSED_MHA_KERNEL = Kernel("fused_mha", "fused_mha.cu",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I]
                          + [_LL] * 9 + [ctypes.c_float, _I, _I, _P])
# mha_blhd's arguments with the mask pointer after the bias
TRAIN_KERNEL = Kernel("mha_blhd_train", "mha_blhd_train.cu",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I]
                      + [_LL] * 6 + [ctypes.c_float, _I, _I, _P])

# mha_blhd's arguments without the dtype and fast flags (bf16 only),
# then the launch plan (ops/_plan.HbatchPlan.launch_args)
HBATCH_KERNEL = Kernel("mha_hbatch", "mha_hbatch.cu",
                       [_P] * 5 + [_I] * 4 + [_LL] * 6
                       + [ctypes.c_float] + [_I] * 6 + [_P])

MAX_LEN = 64
HEAD_DIM = 64
HBATCH_MAX_HEADS = 12   # the widest LXMERT configuration
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def softmax_last(s: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis, in s's dtype: every op rounds
    to that dtype, and the sum accumulates in fp32 (jnp.sum upcasts
    bf16), then rounds back."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.float().sum(-1, keepdim=True).to(e.dtype)


def _attend(qh, kh, vh, bias, fast: bool, mask=None) -> torch.Tensor:
    """The kernels' arithmetic over (B, H, L, D): fp32 q.k^T, times
    1/sqrt(D), cast to the accumulator type (the input type when `fast`,
    else fp32), plus the bias in that type, softmax, p cast to the input
    type, times the mask in the input type (when given), fp32 p.v, the
    result in the input type."""
    B, Lk = kh.shape[0], kh.shape[2]
    D = qh.shape[-1]
    acc = qh.dtype if fast else torch.float32
    s = qh.float() @ kh.float().transpose(-1, -2) * float(
        np.float32(1.0 / np.sqrt(D)))
    s = s.to(acc)
    if bias is not None:
        s = s + bias.reshape(B, 1, 1, Lk).to(acc)
    p = softmax_last(s).to(vh.dtype)
    if mask is not None:
        p = p * mask.to(p.dtype)
    return (p.float() @ vh.float()).to(qh.dtype)


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, H, L, D), a view."""
    B, L, HD = t.shape
    return t.reshape(B, L, n_heads, HD // n_heads).transpose(1, 2)


def mha_blhd_reference(q, k, v, bias, n_heads: int,
                       fast: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the packed-head kernel."""
    B, Lq, HD = q.shape
    ctx = _attend(_heads(q, n_heads), _heads(k, n_heads),
                  _heads(v, n_heads), bias, fast)
    return ctx.transpose(1, 2).reshape(B, Lq, HD)


def mha_blhd_train_reference(q, k, v, bias, mask, n_heads: int,
                             fast: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the training kernel's forward: the
    packed-head kernel with p times `mask` ((B, H, Lq, Lk) pre-scaled
    keep/keep_prob, or None) in the input type before p.v."""
    B, Lq, HD = q.shape
    ctx = _attend(_heads(q, n_heads), _heads(k, n_heads),
                  _heads(v, n_heads), bias, fast, mask)
    return ctx.transpose(1, 2).reshape(B, Lq, HD)


def _einsum_attend(qh, kh, vh, bias, fast: bool, mask=None):
    """The JAX package's einsum attention over (B, H, L, D): the scores
    product in the accumulator type (fp32 unless `fast`), times 1/sqrt(D)
    in that type, + bias, softmax, p in the input type, times the mask
    (when given), p.v in the input type. Differentiable."""
    B, Lk = kh.shape[0], kh.shape[2]
    acc = qh.dtype if fast else torch.float32
    s = torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2))
    # a device scalar made by a fill, not copied from the host: a copy
    # from pageable memory would wait for the card at every call
    s = s * torch.full((), 1.0 / np.sqrt(qh.shape[-1]), dtype=acc,
                       device=s.device)
    if bias is not None:
        s = s + bias.reshape(B, 1, 1, Lk).to(acc)
    p = softmax_last(s).to(qh.dtype)
    if mask is not None:
        p = p * mask.to(p.dtype)
    return torch.matmul(p, vh)


def blhd_einsum_reference(q, k, v, bias, mask, n_heads: int,
                          fast: bool = False) -> torch.Tensor:
    """`_blhd_einsum_ref` of the JAX package: the einsum formulation of
    the training attention that its backward recomputes, over packed
    heads, with the pre-scaled dropout mask (or None) on p.
    Differentiable."""
    B, Lq, HD = q.shape
    ctx = _einsum_attend(*(_heads(t, n_heads) for t in (q, k, v)), bias,
                         fast, mask)
    return ctx.transpose(1, 2).reshape(B, Lq, HD)


def einsum_mha_reference(q, k, v, bias, fast: bool = False) -> torch.Tensor:
    """`_einsum_mha` of the JAX package (`xlxmert_tpu/ops/attention.py`):
    the einsum formulation over (B, H, L, D) that `fused_mha`'s backward
    recomputes. Differentiable in q, k, v and the bias."""
    return _einsum_attend(q, k, v, bias, fast)


def fused_mha_reference(q, k, v, bias, fast: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the (B, H, L, D) kernel."""
    return _attend(q, k, v, bias, fast)


def _check_operand(t: torch.Tensor, name: str, B: int, HD: int, vec: int,
                   what: str):
    if t.dim() != 3 or t.shape[0] != B or t.shape[2] != HD:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected ({B}, L, {HD})")
    if t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec \
            or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs unit column stride, "
                         f"16-byte alignment and row/batch strides that are "
                         f"multiples of {vec} elements; got strides "
                         f"{t.stride()}")


def _check_blhd(what: str, q, k, v, bias, n_heads: int) -> None:
    """What the packed-head kernels take: q/k/v of one dtype on one CUDA
    device, head dim 64, lengths up to 64, a contiguous bf16 bias."""
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    D = HD // n_heads
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D * n_heads != HD or D != HEAD_DIM:
        raise ValueError(f"{what}: head dim {HD}/{n_heads} is not "
                         f"{HEAD_DIM}")
    if not (1 <= Lq <= MAX_LEN and 1 <= Lk <= MAX_LEN):
        raise ValueError(f"{what}: lengths ({Lq}, {Lk}) exceed {MAX_LEN}")
    if v.shape[1] != Lk:
        raise ValueError(f"{what}: k and v lengths differ")
    vec = 16 // q.element_size()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}")
        _check_operand(t, name, B, HD, vec, what)
    if bias is not None and (
            bias.dtype != torch.bfloat16 or bias.device != q.device
            or bias.numel() != B * Lk or not bias.is_contiguous()):
        raise ValueError(f"{what}: bias must be a contiguous bf16 (B, Lk) "
                         f"or (B, 1, 1, Lk) tensor on {q.device}")


def _blhd_args(q, k, v, n_heads: int, fast: bool):
    """The kernels' trailing arguments after the pointers: B, H, Lq, Lk,
    the q/k/v batch and row strides, scale, dtype code, fast."""
    B, Lq, HD = q.shape
    return (B, n_heads, Lq, k.shape[1], q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(np.float32(1.0 / np.sqrt(HD // n_heads))),
            _DTYPE_CODE[q.dtype], int(bool(fast)))


def mha_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor], n_heads: int,
             fast: bool = True) -> torch.Tensor:
    """Fused attention over packed heads; see the module docstring.
    q, k and v may be column slices of one fused projection: only their
    last dimension must be contiguous. The kernel takes head dim 64,
    lengths up to 64 and a bf16 bias (the engine's `_extend_mask`).
    Forward only: a backward through the result raises."""
    return forward_only(
        "mha_blhd has no gradient: the JAX package's mha_blhd has no vjp "
        "(differentiate mha_blhd_reference, or train through "
        "mha_blhd_train)", _mha_blhd_forward, q, k, v, bias, n_heads, fast)


def _mha_blhd_forward(q, k, v, bias, n_heads: int,
                      fast: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_blhd_reference(q, k, v, bias, n_heads, fast)
    if q.device.type != "cuda":
        raise ValueError(f"mha_blhd: unsupported device {q.device}")
    _check_blhd("mha_blhd", q, k, v, bias, n_heads)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        *_blhd_args(q, k, v, n_heads, fast), stream)
    return out


def mha_hbatch_reference(q, k, v, bias, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the batched-head kernel (`kern` of
    `core_hbatch` in scripts/drive_attention_layout.py). Its steps are
    all six of `_attend`'s with fast=True, in the same order: fp32 q.k^T,
    times 1/sqrt(D) in fp32 then rounded to bf16, + bias in bf16, softmax
    in bf16 (`softmax_last`), p in bf16, fp32 p.v rounded to bf16. So it
    is `mha_blhd_reference(fast=True)`: the two TPU kernels compute one
    function and differ in how they organise it (a loop over heads, or
    one batched contraction over (batch, head))."""
    return mha_blhd_reference(q, k, v, bias, n_heads, fast=True)


def mha_hbatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], n_heads: int) -> torch.Tensor:
    """Packed-head attention with the heads of a batch row walked by one
    CTA (`csrc/mha_hbatch.cu`); `mha_blhd(fast=True)`'s function, bits
    and operands, bf16 only, at most 12 heads. The bias ((B, Lk) or
    (B, 1, 1, Lk) bf16) may be None: the kernel then adds nothing, which
    is exact (a bf16 0 added to a bf16 score changes no bit). Forward
    only: a backward through the result raises."""
    return forward_only(
        "mha_hbatch has no gradient: the JAX package's core_hbatch "
        "(scripts/drive_attention_layout.py) has no vjp (differentiate "
        "mha_hbatch_reference)", _mha_hbatch_forward, q, k, v, bias,
        n_heads)


def _mha_hbatch_forward(q, k, v, bias, n_heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_hbatch_reference(q, k, v, bias, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"mha_hbatch: unsupported device {q.device}")
    _check_blhd("mha_hbatch", q, k, v, bias, n_heads)
    if q.dtype != torch.bfloat16 or n_heads > HBATCH_MAX_HEADS:
        raise ValueError(f"mha_hbatch: takes bf16 q/k/v and at most "
                         f"{HBATCH_MAX_HEADS} heads; got {q.dtype}, "
                         f"{n_heads} heads")
    plan = hbatch_plan(q.shape[0], n_heads, q.shape[1], k.shape[1])
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    HBATCH_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        *_blhd_args(q, k, v, n_heads, True)[:-2], *plan.launch_args(),
        stream)
    return out


def _mha_blhd_train_forward(q, k, v, bias, mask, n_heads: int,
                            fast: bool) -> torch.Tensor:
    """The training attention's forward: the kernel for CUDA tensors,
    the plain version for CPU ones."""
    if q.device.type == "cpu":
        return mha_blhd_train_reference(q, k, v, bias, mask, n_heads, fast)
    if q.device.type != "cuda":
        raise ValueError(f"mha_blhd_train: unsupported device {q.device}")
    _check_blhd("mha_blhd_train", q, k, v, bias, n_heads)
    B, Lq, _ = q.shape
    if mask is not None and (
            mask.shape != (B, n_heads, Lq, k.shape[1])
            or mask.dtype != q.dtype or mask.device != q.device
            or not mask.is_contiguous()):
        raise ValueError(f"mha_blhd_train: mask must be a contiguous "
                         f"{q.dtype} ({B}, {n_heads}, {Lq}, {k.shape[1]}) "
                         f"tensor on {q.device}; got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    TRAIN_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        *_blhd_args(q, k, v, n_heads, fast), stream)
    return out


class _MhaBlhdTrain(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, its plain version). Backward:
    `blhd_einsum_reference` recomputed with the saved mask, so the
    (B, H, Lq, Lk) probabilities are never stored (the JAX package's
    `_blhd_train_vjp_bwd`). Gradients for q, k and v; none for the bias
    and the mask, which the model never trains."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, n_heads, fast):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.n_heads, ctx.fast = n_heads, fast
        return _mha_blhd_train_forward(q, k, v, bias, mask, n_heads, fast)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = blhd_einsum_reference(*leaves, bias, mask, ctx.n_heads,
                                        ctx.fast)
            gq, gk, gv = torch.autograd.grad(out, leaves, g)
        return gq, gk, gv, None, None, None, None


def mha_blhd_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   dropout_mask: Optional[torch.Tensor], n_heads: int,
                   fast: bool = False) -> torch.Tensor:
    """Differentiable packed-head attention of the training path; see
    the module docstring. q (B, Lq, H*D), k/v (B, Lk, H*D), bias bf16
    (B, Lk) or (B, 1, 1, Lk) or None, dropout_mask the pre-scaled
    keep/keep_prob (B, H, Lq, Lk) in q's dtype, or None. Each CUDA
    forward launches `csrc/mha_blhd_train.cu` once."""
    return _MhaBlhdTrain.apply(q, k, v, bias, dropout_mask, n_heads, fast)


def _check_heads(t: torch.Tensor, name: str, B: int, H: int, vec: int):
    if t.dim() != 4 or t.shape[0] != B or t.shape[1] != H \
            or t.shape[3] != HEAD_DIM:
        raise ValueError(f"fused_mha: {name} has shape {tuple(t.shape)}, "
                         f"expected ({B}, {H}, L, {HEAD_DIM})")
    if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"fused_mha: {name} needs unit last stride, "
                         f"16-byte alignment and batch/head/row strides "
                         f"that are multiples of {vec} elements; got "
                         f"strides {t.stride()}")


class _FusedMha(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, its plain version). Backward:
    `einsum_mha_reference` recomputed, as the JAX package's custom_vjp
    (`_vjp_bwd`) recomputes `_einsum_mha`: gradients for q, k and v, and
    for the bias when it requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, bias, fast):
        ctx.save_for_backward(q, k, v, bias)
        ctx.fast = fast
        return _fused_mha_forward(q, k, v, bias, fast)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            if ctx.needs_input_grad[3]:
                bias = bias.detach().requires_grad_()
                leaves.append(bias)
            out = einsum_mha_reference(*leaves[:3], bias, ctx.fast)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads[:3], grads[3] if len(grads) > 3 else None, None)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], fast: bool = False
              ) -> torch.Tensor:
    """Fused attention over (B, H, L, D) operands; see the module
    docstring. Returns (B, H, Lq, D), contiguous. q, k and v may be
    strided views (a head transpose of a projection's output): only
    their last dimension must be contiguous. The kernel takes head dim
    64, lengths up to 64 and a contiguous bf16 (B, Lk) bias.
    Differentiable in q, k, v and the bias (`_FusedMha`); with grad off
    or no input requiring grad, the kernel is called directly."""
    if tracks_grad(q, k, v, bias):
        return _FusedMha.apply(q, k, v, bias, fast)
    return _fused_mha_forward(q, k, v, bias, fast)


def _fused_mha_forward(q, k, v, bias, fast: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return fused_mha_reference(q, k, v, bias, fast)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha: unsupported device {q.device}")
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"fused_mha: q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (1 <= Lq <= MAX_LEN and 1 <= Lk <= MAX_LEN):
        raise ValueError(f"fused_mha: lengths ({Lq}, {Lk}) exceed "
                         f"{MAX_LEN}")
    if v.shape[2] != Lk:
        raise ValueError("fused_mha: k and v lengths differ")
    vec = 16 // q.element_size()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"fused_mha: {name} is on {t.device}")
        _check_heads(t, name, B, H, vec)
    if bias is not None and (
            bias.dtype != torch.bfloat16 or bias.device != q.device
            or bias.numel() != B * Lk or not bias.is_contiguous()):
        raise ValueError("fused_mha: bias must be a contiguous bf16 (B, Lk) "
                         f"tensor on {q.device}")
    out = torch.empty((B, H, Lq, HEAD_DIM), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FUSED_MHA_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, H,
        Lq, Lk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(np.float32(1.0 / np.sqrt(HEAD_DIM))), _DTYPE_CODE[q.dtype],
        int(bool(fast)), stream)
    return out
