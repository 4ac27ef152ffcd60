"""Card-only checks of the port's CUDA kernels against their plain
PyTorch versions, at the serving and training paths' shapes and at
ragged ones.

Marked `gpu`; each test skips from its fixture when no CUDA device is
present. This file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops import (
    _plan, attention, fused_block, ffn, int8_matmul, quant,
)
from xlxmert_tpu_torch.ops.quant import quantize_weight, with_activation_scale

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the paths' int8 dense shapes)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(rng, B, Lq, Lk, HD, dtype, dev):
    """q from a fused (B, Lq, 3*HD) projection, k/v from a fused
    (B, Lk, 2*HD) one: column slices, as the engine passes them."""
    qkv = torch.from_numpy(rng.randn(B, Lq, 3 * HD).astype(np.float32))
    kv = torch.from_numpy(rng.randn(B, Lk, 2 * HD).astype(np.float32))
    qkv, kv = qkv.to(dev, dtype), kv.to(dev, dtype)
    return qkv[..., :HD], kv[..., :HD], kv[..., HD:]


# every (Lq, Lk) of the serving paths (text buckets 8-20 against
# themselves and the 64 visual cells), and ragged lengths: key and query
# tiles of 16 cut at 1, 7, 15, 17, 33 and 63
ATTENTION_SHAPES = sorted({(L, L) for L in (8, 12, 16, 20, 64)}
                          | {(L, 64) for L in (8, 12, 16, 20)}
                          | {(64, L) for L in (8, 12, 16, 20)}
                          | {(1, 1), (7, 33), (33, 7), (15, 17), (17, 15),
                             (63, 63), (1, 63), (63, 1)})
# bf16 runs on tensor cores: the scores, the softmax sum and both
# products add in another order, one bf16 step at |out| ~ 2; fp32 runs
# on CUDA cores, sums in another order
ATTENTION_TYPES = [(torch.bfloat16, True, 2e-2), (torch.bfloat16, False, 2e-2),
                   (torch.float32, False, 1e-5)]


@pytest.mark.parametrize("Lq,Lk", ATTENTION_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype,fast,tol", ATTENTION_TYPES)
@pytest.mark.parametrize("B", [256, 8])
def test_mha_blhd_kernel_matches_plain(cuda, Lq, Lk, with_bias, dtype,
                                       fast, tol, B):
    """Column slices of fused projections (the engines' operands) at the
    serving batch and calibration's."""
    rng = np.random.RandomState(Lq * 100 + Lk + B)
    H, D = 12, 64
    q, k, v = _qkv(rng, B, Lq, Lk, H * D, dtype, cuda)
    bias = None
    if with_bias:
        m = np.ones((B, Lk), np.float32)
        m[1, Lk // 2:] = 0
        bias = ((1.0 - torch.from_numpy(m)) * -1e9)[:, None, None, :].to(
            cuda, torch.bfloat16)
    before = attention.KERNEL.launches
    out = attention.mha_blhd(q, k, v, bias, H, fast=fast)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    ref = attention.mha_blhd_reference(q, k, v, bias, H, fast=fast)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, err


def test_mha_blhd_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 65, 768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceed"):
        attention.mha_blhd(q, q, q, None, 12)
    q = torch.zeros(2, 8, 12 * 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.mha_blhd(q, q, q, None, 12)
    q = torch.zeros(2, 8, 768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        attention.mha_blhd(q, q, q, torch.zeros(2, 8, device=cuda), 12)


# the attention-layout driver's shapes at L=20 (the text keys carry the
# padding bias, the visual keys none), the other bucket lengths, and
# ragged ones; B=256 (the driver's batch) and 8 (calibration's)
HBATCH_SHAPES = [(20, 20), (64, 64), (20, 64), (64, 20), (8, 8), (12, 64),
                 (64, 16), (7, 33), (33, 7), (1, 1)]


@pytest.mark.parametrize("Lq,Lk", HBATCH_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("B", [256, 8])
def test_mha_hbatch_kernel_matches_plain(cuda, Lq, Lk, with_bias, B):
    """bf16 out within 2e-2 of the plain version (the softmax sum and
    both products add in another order: one bf16 step at |out| ~ 2), and
    bit-equal to mha_blhd(fast=True), whose per-tile body every head
    runs."""
    rng = np.random.RandomState(Lq * 100 + Lk + B)
    H = 12
    q, k, v = _qkv(rng, B, Lq, Lk, H * 64, torch.bfloat16, cuda)
    bias = None
    if with_bias:
        m = (rng.rand(B, Lk) > 0.3).astype(np.float32)
        m[:, 0] = 1
        bias = ((1.0 - torch.from_numpy(m)) * -1e9)[:, None, None, :].to(
            cuda, torch.bfloat16)
    before = attention.HBATCH_KERNEL.launches
    out = attention.mha_hbatch(q, k, v, bias, H)
    torch.cuda.synchronize()
    assert attention.HBATCH_KERNEL.launches == before + 1
    ref = attention.mha_hbatch_reference(q, k, v, bias, H)
    assert out.shape == ref.shape == (B, Lq, H * 64)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.isfinite(out).all()
    assert torch.equal(out, attention.mha_blhd(q, k, v, bias, H, fast=True))
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def near_tie_qkv(rng, B, L, H):
    """q, k, v (B, L, H*64) as float32 arrays of bf16 values, where each
    query row's scaled score against key 0 of its (b, h) lies at a bf16
    rounding midpoint plus half an fp32 step by its exact sum, but one
    full step above it by the plain version's fp32 chain (one fused
    multiply-add per column, in order). Column 0 gives 17 a / 8 (a odd,
    17..29: 17 a / 64 is a midpoint of two bf16 values in [4, 8)),
    columns 1 and 2 add 0.75 and -0.25 of the fp32 step at it (2^-18);
    key 0 is zero past column 2 and the other keys zero below it, so their
    scores are small and key 0 takes most of p. A sum in another order
    (the tensor cores') can round such a score to the other bf16
    neighbour, which moves the context by up to ~0.03."""
    D = 64
    q = rng.randn(B, L, H, D).astype(np.float32)
    k = (rng.randn(B, L, H, D) * 0.1).astype(np.float32)
    q[..., 0] = rng.choice(np.arange(17, 31, 2), size=(B, L, H))
    q[..., 1] = 0.75 * 2.0 ** -9
    q[..., 2] = -0.25 * 2.0 ** -9
    k[..., :3] = 0
    k[:, 0] = 0
    k[:, 0, :, 0] = 17 / 8
    k[:, 0, :, 1:3] = 2.0 ** -9
    v = rng.randn(B, L, H, D).astype(np.float32)
    bf16 = [torch.from_numpy(t.reshape(B, L, H * D)).to(torch.bfloat16)
            .float().numpy() for t in (q, k, v)]
    return tuple(bf16)


def test_mha_hbatch_kernel_at_bf16_rounding_ties(cuda):
    """The 64 x 64 padding-bias shape at B=256 with every query row's
    dominant score near a bf16 rounding midpoint (near_tie_qkv): bit-equal
    to mha_blhd(fast=True), which recomputes such scores in the plain
    version's order, and within 2e-2 of the plain version."""
    rng = np.random.RandomState(6)
    B, L, H = 256, 64, 12
    q, k, v = (torch.from_numpy(t).to(cuda, torch.bfloat16)
               for t in near_tie_qkv(rng, B, L, H))
    m = (rng.rand(B, L) > 0.3).astype(np.float32)
    m[:, 0] = 1
    bias = ((1.0 - torch.from_numpy(m)) * -1e9)[:, None, None, :].to(
        cuda, torch.bfloat16)
    before = attention.HBATCH_KERNEL.launches
    out = attention.mha_hbatch(q, k, v, bias, H)
    torch.cuda.synchronize()
    assert attention.HBATCH_KERNEL.launches == before + 1
    assert torch.equal(out, attention.mha_blhd(q, k, v, bias, H, fast=True))
    ref = attention.mha_hbatch_reference(q, k, v, bias, H)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def test_mha_hbatch_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 8, 768, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        attention.mha_hbatch(q, q, q, None, 12)
    q = torch.zeros(2, 8, 16 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="heads"):
        attention.mha_hbatch(q, q, q, None, 16)
    q = torch.zeros(2, 65, 768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceed"):
        attention.mha_hbatch(q, q, q, None, 12)
    # a plan whose bytes or warps the kernel does not compute for the
    # shape: the C entry point launches nothing and returns an error
    q = torch.zeros(2, 8, 768, device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    plan = _plan.hbatch_plan(2, 12, 8, 8)
    stream = torch.cuda.current_stream().cuda_stream
    before = attention.HBATCH_KERNEL.launches
    for bad in (plan._replace(smem=plan.smem + 16),
                plan._replace(warps=plan.warps + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            attention.HBATCH_KERNEL.launch(
                q.data_ptr(), q.data_ptr(), q.data_ptr(), None,
                out.data_ptr(), *attention._blhd_args(q, q, q, 12, True)[:-2],
                *bad.launch_args(), stream)
    assert attention.HBATCH_KERNEL.launches == before


# the training path's shapes (text 20, visual 64, both cross directions)
# with the bias it gives each (text keys are masked), and a ragged one
TRAIN_SHAPES = [(20, 20, True), (64, 64, False), (20, 64, False),
                (64, 20, True), (7, 33, True)]


def _train_operands(rng, B, Lq, Lk, with_bias, with_mask, dtype, dev):
    H, D = 12, 64
    q, k, v = _qkv(rng, B, Lq, Lk, H * D, dtype, dev)
    bias = mask = None
    if with_bias:
        m = np.ones((B, Lk), np.float32)
        m[1, Lk // 2:] = 0
        bias = ((1.0 - torch.from_numpy(m)) * -1e9).to(dev, torch.bfloat16)
    if with_mask:
        keep = torch.from_numpy(rng.rand(B, H, Lq, Lk) < 0.9).to(dev)
        mask = keep.to(dtype) / torch.tensor(0.9, dtype=dtype, device=dev)
    return q, k, v, bias, mask


@pytest.mark.parametrize("Lq,Lk,with_bias", TRAIN_SHAPES)
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("dtype,tol", [
    (torch.bfloat16, 2e-2),   # bf16 out and p*mask: rounding order
    (torch.float32, 1e-5),    # fp32 sums in another order
])
def test_mha_blhd_train_kernel_matches_plain(cuda, Lq, Lk, with_bias,
                                             with_mask, dtype, tol):
    rng = np.random.RandomState(Lq * 100 + Lk)
    args = _train_operands(rng, 32, Lq, Lk, with_bias, with_mask, dtype,
                           cuda)
    before = attention.TRAIN_KERNEL.launches
    out = attention.mha_blhd_train(*args, 12)
    torch.cuda.synchronize()
    assert attention.TRAIN_KERNEL.launches == before + 1
    ref = attention.mha_blhd_train_reference(*args, 12)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_blhd_train_forward_and_backward_match_the_cpu(cuda, dtype):
    """Forward (the kernel) and backward (the recompute) on the card
    against the same Function on the CPU (the plain forward): fp32 to
    1e-4; bf16 by cosine, the products' sums order differs."""
    rng = np.random.RandomState(4)
    q, k, v, bias, mask = _train_operands(rng, 8, 20, 64, False, True,
                                          dtype, cuda)
    g = torch.from_numpy(rng.randn(8, 20, 768).astype(np.float32)).to(dtype)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = attention.TRAIN_KERNEL.launches
        out = attention.mha_blhd_train(*leaves, None, mask.to(dev), 12)
        out.backward(g.to(dev))
        assert attention.TRAIN_KERNEL.launches == before + (
            dev.type == "cuda")
        res[dev.type] = [t.detach().float().cpu() for t in
                         (out, *(x.grad for x in leaves))]
    for a, b in zip(res["cuda"], res["cpu"]):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            cos = torch.nn.functional.cosine_similarity(
                a.flatten(), b.flatten(), dim=0).item()
            assert cos > 0.999, cos


# bf16 runs attention_mma.cuh's tensor-core body with the mask operand:
# ragged key and query tiles (1, 7, 15, 17, 33, 63: odd key counts read
# the mask 2 bytes at a time), the training shapes, fast or not
TRAIN_RAGGED = [(1, 1), (7, 33), (33, 7), (15, 17), (17, 15), (63, 63),
                (1, 63), (63, 1), (20, 20), (64, 64), (20, 64), (64, 20)]


@pytest.mark.parametrize("Lq,Lk", TRAIN_RAGGED)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("mask_kind", ["dropout", "rows dropped", "none"])
@pytest.mark.parametrize("dtype,fast,tol", ATTENTION_TYPES)
def test_mha_blhd_train_kernel_on_ragged_tiles(cuda, Lq, Lk, with_bias,
                                               mask_kind, dtype, fast, tol):
    """Column slices of fused projections; the mask at the model's
    dropout rate, or with whole query rows dropped (their context is
    0). bf16 within 2e-2 of the plain version (p, p * mask and both
    products round or add in another order), fp32 (attention.cuh)
    within 1e-5."""
    rng = np.random.RandomState(Lq * 100 + Lk + 7)
    B = 8
    q, k, v, bias, mask = _train_operands(rng, B, Lq, Lk, with_bias,
                                          mask_kind != "none", dtype, cuda)
    if mask_kind == "rows dropped":
        mask[:, :, ::3] = 0
        mask[1] = 0
    before = attention.TRAIN_KERNEL.launches
    out = attention.mha_blhd_train(q, k, v, bias, mask, 12, fast=fast)
    torch.cuda.synchronize()
    assert attention.TRAIN_KERNEL.launches == before + 1
    ref = attention.mha_blhd_train_reference(q, k, v, bias, mask, 12,
                                             fast=fast)
    assert out.shape == ref.shape == (B, Lq, 768) and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, err
    if mask_kind == "rows dropped":
        assert out[1].abs().max().item() == 0
        assert out.view(B, Lq, 12, 64)[:, ::3].abs().max().item() == 0


def test_mha_blhd_train_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 8, 768, device=cuda, dtype=torch.bfloat16)
    bad = torch.ones(2, 12, 8, 8, device=cuda)   # fp32 mask, bf16 q
    with pytest.raises(ValueError, match="mask"):
        attention.mha_blhd_train(q, q, q, None, bad, 12)
    with pytest.raises(ValueError, match="mask"):
        attention.mha_blhd_train(q, q, q, None, bad[:, :6].to(q.dtype), 12)
    with pytest.raises(ValueError, match="exceed"):
        q65 = torch.zeros(2, 65, 768, device=cuda, dtype=torch.bfloat16)
        attention.mha_blhd_train(q65, q65, q65, None, None, 12)


@pytest.mark.parametrize("M,K,N", [
    (8, 1536, 3129), (256, 768, 1536), (160, 768, 2304), (512, 2048, 768),
    (2048, 3072, 768), (100, 768, 17), (1, 32, 8)])
@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_kernel_matches_plain(cuda, M, K, N, static):
    """Integer products are exact in both versions and the float
    epilogue runs the same operations in the same order: bit-equal."""
    _int8_check(cuda, M, K, N, static, M + K + N)


def _int8_check(dev, M, K, N, static, seed):
    """int8_dense against its plain version, bit for bit, one launch."""
    rng = np.random.RandomState(seed)
    qw = quantize_weight(rng.randn(K, N).astype(np.float32) * 0.05,
                         rng.randn(N).astype(np.float32) * 0.1).to(dev)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32) * 2).to(
        dev, torch.bfloat16)
    inv_a, col = None, qw.scale
    if static:
        with_activation_scale(qw, 0.8 * x.float().abs().max().item())
        inv_a, col = qw.inv_a, qw.out_scale
    before = int8_matmul.KERNEL.launches
    out = int8_matmul.int8_dense_fused(x, qw.w_i8, col, qw.bias, inv_a)
    torch.cuda.synchronize()
    assert int8_matmul.KERNEL.launches == before + 1
    ref = int8_matmul.int8_dense_reference(x, qw.w_i8, col, qw.bias, inv_a)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


# every (M, K, N) the serving, calibration and fine-tuning evaluation
# paths give the int8 dense (chip_smoke's kernel phase), in both modes
INT8_PATH_SHAPES = sorted({(M, K, N) for M, K, N, _, _ in
                           chip_smoke.dense_cases(LxmertConfig(), 256,
                                                  3129)})


@pytest.mark.parametrize("M,K,N", INT8_PATH_SHAPES)
@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_kernel_matches_plain_at_the_path_shapes(cuda, M, K, N,
                                                            static):
    _int8_check(cuda, M, K, N, static, M + K + N)


@pytest.mark.parametrize("M", [1, 8, 63, 64, 65, 127, 128, 129, 257])
@pytest.mark.parametrize("N", [2, 17, 136, 3129])
@pytest.mark.parametrize("K", [16, 32, 48, 2048])
@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_kernel_matches_plain_at_tile_edges(cuda, M, N, K,
                                                       static):
    """Rows, columns and K cut inside a tile and inside a 64-deep step
    (K = 16, 32, 48 are shorter than one)."""
    _int8_check(cuda, M, K, N, static, 7 * M + 3 * N + K)


# ragged shapes that take each of the kernel's tiles: 128 x 256 (runs of
# tiles that stay in one row block, and runs that cross row blocks, where
# the dynamic mode computes new row scales), 64 x 128, 64 x 64
@pytest.mark.parametrize("M,K,N", [
    (16383, 768, 3129), (9000, 768, 1000), (5121, 48, 1000),
    (4095, 32, 770), (2047, 48, 761), (2049, 16, 136), (300, 1536, 3129),
    (100, 2048, 700)])
@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_kernel_matches_plain_in_every_tile(cuda, M, K, N,
                                                       static):
    _int8_check(cuda, M, K, N, static, M + N)


def test_int8_dense_kernel_rejects_what_it_cannot_take(cuda):
    qw = quantize_weight(np.ones((24, 8), np.float32)).to(cuda)
    x = torch.zeros(4, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul.int8_dense_fused(x, qw.w_i8, qw.scale)
    qw = quantize_weight(np.ones((32, 8), np.float32)).to(cuda)
    x = torch.zeros(4, 32, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        int8_matmul.int8_dense_fused(x, qw.w_i8, qw.scale)


@pytest.mark.parametrize("Lq,Lk", ATTENTION_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype,fast,tol", ATTENTION_TYPES)
@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("B", [256, 8])
def test_fused_mha_kernel_matches_plain(cuda, Lq, Lk, with_bias, dtype,
                                        fast, tol, views, B):
    """(B, H, L, D) operands, contiguous or head-transposed views of the
    projections (the model's "pallas" route); (B, Lk) bf16 bias."""
    rng = np.random.RandomState(Lq * 100 + Lk + 7 + B)
    H, D = 12, 64
    q, k, v = (t.view(B, -1, H, D).transpose(1, 2)
               for t in _qkv(rng, B, Lq, Lk, H * D, dtype, cuda))
    if not views:
        q, k, v = (t.contiguous() for t in (q, k, v))
    bias = None
    if with_bias:
        m = np.ones((B, Lk), np.float32)
        m[2, Lk // 3:] = 0
        bias = ((1.0 - torch.from_numpy(m)) * -1e9).to(cuda, torch.bfloat16)
    before = attention.FUSED_MHA_KERNEL.launches
    out = attention.fused_mha(q, k, v, bias, fast)
    torch.cuda.synchronize()
    assert attention.FUSED_MHA_KERNEL.launches == before + 1
    ref = attention.fused_mha_reference(q, k, v, bias, fast)
    assert out.shape == (B, H, Lq, D) and out.dtype == dtype
    assert out.is_contiguous()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("Lq,Lk", [(20, 64), (64, 20), (20, 20)])
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
def test_fused_mha_backward_matches_the_cpu(cuda, Lq, Lk, dtype, fast):
    """Forward (the kernel) and backward (einsum_mha_reference recomputed)
    on the card, with q, k, v and the bias requiring grad, against the
    einsum's gradients on the CPU: fp32 to 1e-4; bf16 to 2e-2 (the
    products' sums add in another order)."""
    rng = np.random.RandomState(Lq * 100 + Lk + 11)
    B, H, D = 8, 12, 64
    q, k, v = (t.view(B, -1, H, D).transpose(1, 2)
               for t in _qkv(rng, B, Lq, Lk, H * D, dtype, cuda))
    bias = torch.from_numpy(0.5 * rng.randn(B, Lk).astype(np.float32))
    bias[1, Lk // 2:] = -1e9
    g = torch.from_numpy(rng.randn(B, H, Lq, D).astype(np.float32))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    res = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        b = bias.to(dev, torch.bfloat16).requires_grad_()
        before = attention.FUSED_MHA_KERNEL.launches
        if dev.type == "cuda":
            out = attention.fused_mha(*leaves, b, fast)
        else:
            out = attention.einsum_mha_reference(*leaves, b, fast)
        out.backward(g.to(dev, dtype))
        assert attention.FUSED_MHA_KERNEL.launches == before + (
            dev.type == "cuda")
        res[dev.type] = [t.detach().float().cpu()
                         for t in (out, *(x.grad for x in leaves), b.grad)]
    for name, a, r in zip(("out", "q", "k", "v", "bias"), res["cuda"],
                          res["cpu"]):
        torch.testing.assert_close(a, r, atol=tol, rtol=tol, msg=name)


def test_forward_only_kernels_refuse_a_backward_on_the_card(cuda):
    """mha_blhd, mha_hbatch and fused_ffn on CUDA tensors that require
    grad: the kernel launches, gives the bits it gives with grad off, and
    the backward raises instead of dropping the gradient."""
    rng = np.random.RandomState(12)
    q, k, v = _qkv(rng, 8, 20, 20, 768, torch.bfloat16, cuda)
    x = torch.from_numpy(rng.randn(40, 768).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w1, w2 = (torch.from_numpy(0.02 * rng.randn(*s).astype(np.float32)).to(
        cuda, torch.bfloat16) for s in ((3072, 768), (768, 3072)))
    vecs = [torch.zeros(n, device=cuda) for n in (3072, 768, 768, 768)]
    cases = {
        "mha_blhd": (attention.KERNEL, lambda q, k, v:
                     attention.mha_blhd(q, k, v, None, 12)),
        "mha_hbatch": (attention.HBATCH_KERNEL, lambda q, k, v:
                       attention.mha_hbatch(q, k, v, None, 12)),
        "fused_ffn": (ffn.KERNEL, lambda q, k, v: ffn.fused_ffn(
            x, w1, vecs[0], w2, *vecs[1:])),
    }
    for name, (kernel, fn) in cases.items():
        with torch.no_grad():
            want = fn(q, k, v)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        if name == "fused_ffn":
            w1.requires_grad_()
        before = kernel.launches
        out = fn(*leaves)
        assert kernel.launches == before + 1
        assert out.grad_fn is not None
        torch.testing.assert_close(out.detach(), want, atol=0, rtol=0)
        with pytest.raises(RuntimeError, match=f"{name} has no gradient"):
            out.float().sum().backward()
        w1.requires_grad_(False)


@pytest.mark.parametrize("M", [5120, 16384, 160, 512, 37, 1])
@pytest.mark.parametrize("approx", [True, False])
def test_fused_ffn_kernel_matches_plain(cuda, M, approx):
    """bf16 rows at the model's widths (768, 3072), ragged row counts
    too: fp32 sums in another order move an output across a bf16
    rounding boundary at most, one step at the largest output; 99 % of
    the outputs are equal."""
    rng = np.random.RandomState(M)
    H, I = 768, 3072

    def t(*shape, scale=1.0, dtype=torch.float32):
        a = rng.randn(*shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, dtype)

    x = t(M, H, dtype=torch.bfloat16)
    w1 = t(I, H, scale=0.02, dtype=torch.bfloat16)
    w2 = t(H, I, scale=0.02, dtype=torch.bfloat16)
    b1, b2, be = t(I, scale=0.02), t(H, scale=0.02), t(H, scale=0.02)
    g = 1.0 + t(H, scale=0.1)
    before = ffn.KERNEL.launches
    out = ffn.fused_ffn(x, w1, b1, w2, b2, g, be, approx_gelu=approx)
    torch.cuda.synchronize()
    assert ffn.KERNEL.launches == before + 1
    ref = ffn.fused_ffn_reference(x, w1, b1, w2, b2, g, be,
                                  approx_gelu=approx)
    assert out.shape == (M, H) and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err
    assert (out == ref).float().mean().item() >= 0.99


CFG = LxmertConfig()
FFN_PATH_ROWS = [M for M, _ in chip_smoke.ffn_cases(CFG, chip_smoke.BATCH)]
EDGE_ROWS = [1, 63, 64, 65, 127, 129, 200]


def _ffn_operands(rng, dev, M, I):
    H = 768

    def t(*shape, scale=1.0, dtype=torch.float32):
        a = rng.randn(*shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    return (t(M, H, dtype=torch.bfloat16),
            t(I, H, scale=0.02, dtype=torch.bfloat16), t(I, scale=0.02),
            t(H, I, scale=0.02, dtype=torch.bfloat16), t(H, scale=0.02),
            1.0 + t(H, scale=0.1), t(H, scale=0.02))


def _ffn_check(args, approx, equal=0.99):
    before = ffn.KERNEL.launches
    out = ffn.fused_ffn(*args, approx_gelu=approx)
    torch.cuda.synchronize()
    assert ffn.KERNEL.launches == before + 1
    ref = ffn.fused_ffn_reference(*args, approx_gelu=approx)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err
    assert (out == ref).float().mean().item() >= equal
    return out


@pytest.mark.parametrize("M", FFN_PATH_ROWS)
def test_fused_ffn_kernel_matches_plain_at_the_path_shapes(cuda, M):
    """Every row count of the paths (chip_smoke.ffn_cases), tanh gelu as
    serving runs it, with the launch plan the wrapper picks."""
    _ffn_check(_ffn_operands(np.random.RandomState(M), cuda, M, 3072), True)


@pytest.mark.parametrize("M", EDGE_ROWS)
@pytest.mark.parametrize("I", [64, 192, 3072])
@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("split", [1, 2])
def test_fused_ffn_kernel_at_the_design_edges(cuda, monkeypatch, M, I,
                                              approx, split):
    """Rows around a CTA's 64 and a pair's, the smallest and a ragged
    intermediate (chunks of 128: 64 and 192 end in half a chunk), both
    gelu forms, each cluster split the kernel takes (a split needs an
    even number of chunks). The bound on the largest error is the
    path's; the share of equal outputs is 98 %: below M = 16 there are
    as few as 768 outputs, of which a bf16 step from the fp32 sums'
    order moves about one in a hundred."""
    if -(-I // 128) % split:
        pytest.skip("the split does not divide the intermediate's chunks")
    monkeypatch.setattr(ffn, "launch_plan", lambda M_, I_: split)
    _ffn_check(_ffn_operands(np.random.RandomState(M + I), cuda, M, I),
               approx, equal=0.98)


def test_fused_ffn_weight_descriptors_survive_other_weights(cuda):
    """A weight's TMA descriptor is built once and kept (by address and
    shape): after another weight of the same shape was used, and after
    that one was freed and a third allocated, each still gives its own
    plain version's result, and the first its earlier bits."""
    rng = np.random.RandomState(7)
    first = _ffn_operands(rng, cuda, 256, 3072)
    out = _ffn_check(first, True)
    other = _ffn_operands(rng, cuda, 256, 3072)
    _ffn_check(other, True)
    del other
    third = _ffn_operands(rng, cuda, 256, 3072)
    _ffn_check(third, True)
    assert torch.equal(_ffn_check(first, True), out)


def test_fused_ffn_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(4, 768, device=cuda, dtype=torch.bfloat16)
    w1 = torch.zeros(100, 768, device=cuda, dtype=torch.bfloat16)
    w2 = torch.zeros(768, 100, device=cuda, dtype=torch.bfloat16)
    vecs = [torch.zeros(n, device=cuda) for n in (100, 768, 768, 768)]
    with pytest.raises(ValueError, match="multiple of 64"):
        ffn.fused_ffn(x, w1, vecs[0], w2, *vecs[1:])
    with pytest.raises(ValueError, match="bf16 rows"):
        ffn.fused_ffn(x.float(), w1, vecs[0], w2, *vecs[1:])


def _fused_weight(rng, k, n, amax, dev):
    qw = quantize_weight(rng.randn(k, n).astype(np.float32) * 0.03,
                         rng.randn(n).astype(np.float32) * 0.05)
    return fused_block.fused_weight(with_activation_scale(qw, amax)).to(dev)


def _block_operands(rng, dev, M, I=3072, Nq=2304):
    H = 768

    def vec(scale, shift=0.0):
        return torch.from_numpy(
            (rng.randn(H) * scale + shift).astype(np.float32)).to(dev)

    ctx, x = (torch.from_numpy(rng.randn(M, H).astype(np.float32)).to(
        dev, torch.bfloat16) for _ in range(2))
    weights = {"out_w": _fused_weight(rng, H, H, 4.0, dev),
               "w1": _fused_weight(rng, H, I, 4.5, dev),
               "w2": _fused_weight(rng, I, H, 2.5, dev),
               "tail_w": _fused_weight(rng, H, Nq, 4.5, dev)}
    lns = [vec(0.1, 1.0), vec(0.05), vec(0.1, 1.0), vec(0.05)]
    return ctx, x, weights, lns


@pytest.mark.parametrize("M", [2048, 16384, 160, 50, 15, 1])
@pytest.mark.parametrize("ffn_on,tail_on", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_fused_block_kernel_matches_plain(cuda, M, ffn_on, tail_on):
    """Exact int32 products; the LayerNorm sums in another order can move
    a bf16 y1 by one step, and so one int8 step downstream."""
    rng = np.random.RandomState(M + 2 * ffn_on + tail_on)
    ctx, x, w, (g1, b1, g2, b2) = _block_operands(rng, cuda, M)
    ffn_w = (w["w1"], w["w2"], g2, b2) if ffn_on else (None,) * 4
    tail_w = w["tail_w"] if tail_on else None
    before = fused_block.KERNEL.launches
    out = fused_block.fused_block(ctx, x, w["out_w"], g1, b1, *ffn_w,
                                  tail_w=tail_w, has_ffn=ffn_on)
    torch.cuda.synchronize()
    assert fused_block.KERNEL.launches == before + 1
    ref = fused_block.fused_block_reference(
        ctx, x, w["out_w"], fused_block.LN(g1, b1),
        *((w["w1"], w["w2"], fused_block.LN(g2, b2)) if ffn_on
          else (None,) * 3), tail_w)
    outs, refs = ((out, ref) if tail_on else ((out,), (ref,)))
    assert len(outs) == len(refs) == 1 + tail_on
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == torch.bfloat16
        o, r = o.float(), r.float()
        err = (o - r).abs().max().item()
        assert err <= 2.0 ** -6 * r.abs().max().item(), err
        cos = (o * r).sum() / (o.norm() * r.norm())
        assert cos.item() > 0.9999, cos.item()


BLOCK_PATH_CASES = [(M, v) for M, v, _ in chip_smoke.fused_block_cases(
    CFG, chip_smoke.BATCH)]
VARIANTS = {"ffn+tail": (True, True), "ffn": (True, False),
            "tail": (False, True)}


def _block_check(ctx, x, w, lns, ffn_on, tail_on):
    g1, b1, g2, b2 = lns
    ffn_w = (w["w1"], w["w2"], g2, b2) if ffn_on else (None,) * 4
    tail_w = w["tail_w"] if tail_on else None
    before = fused_block.KERNEL.launches
    out = fused_block.fused_block(ctx, x, w["out_w"], g1, b1, *ffn_w,
                                  tail_w=tail_w, has_ffn=ffn_on)
    torch.cuda.synchronize()
    assert fused_block.KERNEL.launches == before + 1
    ref = fused_block.fused_block_reference(
        ctx, x, w["out_w"], fused_block.LN(g1, b1),
        *((w["w1"], w["w2"], fused_block.LN(g2, b2)) if ffn_on
          else (None,) * 3), tail_w)
    outs, refs = ((out, ref) if tail_on else ((out,), (ref,)))
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == torch.bfloat16
        o, r = o.float(), r.float()
        err = (o - r).abs().max().item()
        assert err <= 2.0 ** -6 * r.abs().max().item(), err
        cos = (o * r).sum() / (o.norm() * r.norm())
        assert cos.item() > 0.9999, cos.item()
    return outs


@pytest.mark.parametrize("M,variant", BLOCK_PATH_CASES)
def test_fused_block_kernel_matches_plain_at_the_path_shapes(cuda, M,
                                                             variant):
    """Every (rows, variant) of the fused path (chip_smoke's
    fused_block_cases), with the launch plan the wrapper picks."""
    rng = np.random.RandomState(M + len(variant))
    ctx, x, w, lns = _block_operands(rng, cuda, M)
    _block_check(ctx, x, w, lns, *VARIANTS[variant])


@pytest.mark.parametrize("M", EDGE_ROWS)
@pytest.mark.parametrize("I,Nq", [(128, 128), (384, 256), (3072, 2304)])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("split", [1, 2])
def test_fused_block_kernel_at_the_design_edges(cuda, monkeypatch, M, I, Nq,
                                                variant, split):
    """Rows around a CTA's 64, the smallest and other intermediate and
    tail widths the wrapper takes (multiples of 128), each cluster split
    the kernel takes (a split needs an even number of chunks)."""
    ffn_on = VARIANTS[variant][0]
    if ffn_on and (I // 128) % split:
        pytest.skip("the split does not divide the intermediate's chunks")
    monkeypatch.setattr(fused_block, "launch_plan", lambda M_, I_: split)
    rng = np.random.RandomState(M + I + Nq)
    ctx, x, w, lns = _block_operands(rng, cuda, M, I=I, Nq=Nq)
    _block_check(ctx, x, w, lns, *VARIANTS[variant])


def test_fused_block_weight_descriptors_survive_other_weights(cuda):
    """As for fused_ffn: the kept TMA descriptors (by address and shape)
    give each weight its own result after others of its shape were used,
    freed and replaced, and the first its earlier bits."""
    rng = np.random.RandomState(11)
    ctx, x, first, lns = _block_operands(rng, cuda, 256)
    out = _block_check(ctx, x, first, lns, True, True)
    _, _, other, _ = _block_operands(rng, cuda, 256)
    _block_check(ctx, x, other, lns, True, True)
    del other
    _, _, third, _ = _block_operands(rng, cuda, 256)
    _block_check(ctx, x, third, lns, True, True)
    again = _block_check(ctx, x, first, lns, True, True)
    assert all(torch.equal(a, b) for a, b in zip(again, out))


def test_fused_block_kernel_rejects_what_it_cannot_take(cuda):
    rng = np.random.RandomState(0)
    ctx, x, w, (g1, b1, g2, b2) = _block_operands(rng, cuda, 8, I=192)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_block.fused_block(ctx, x, w["out_w"], g1, b1, w["w1"],
                                w["w2"], g2, b2)
    with pytest.raises(ValueError, match="bf16 rows"):
        fused_block.fused_block(ctx.float(), x.float(), w["out_w"], g1, b1,
                                has_ffn=False)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block.fused_block(ctx.t().contiguous().t(), x, w["out_w"], g1,
                                b1, has_ffn=False)
    small = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="768"):
        fused_block.fused_block(small, small, w["out_w"], g1, b1,
                                has_ffn=False)


def _pretrain_engine(dev, bf16):
    from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    mcfg = LxmertConfig(vocab_size=200, hidden_size=128,
                        num_attention_heads=2, intermediate_size=256,
                        l_layers=2, x_layers=2, r_layers=1,
                        visual_feat_dim=32, num_clusters=50,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    tcfg = TrainConfig(batch_size=8, max_text_length=12, grid_size=8,
                       num_clusters=50, feat_dim=32, lr=1e-3,
                       mixed_precision=bf16)
    return PretrainEngine(tcfg, mcfg, total_steps=10,
                          train_attention="pallas_blhd", device=dev)


def _pretrain_batch(rng):
    word = rng.randint(1, 200, (8, 12))
    word[0, 9:] = 0
    pos = (rng.rand(8, 12) < 0.15) & (word > 0)
    pos[:, 1] = True
    masked, label = word.copy(), np.full_like(word, -1)
    label[pos], masked[pos] = word[pos], 103
    vis = (rng.rand(8, 64) < 0.3).astype(np.float32)
    vis[:, 0] = 1
    return {"word_id": word, "masked_word_id": masked, "word_label": label,
            "other_word_id": rng.randint(1, 200, (8, 12)),
            "matched_label": rng.randint(0, 2, 8),
            "cluster_id": rng.randint(0, 50, (8, 64)), "vis_mask": vis}


@pytest.mark.parametrize("bf16,rel,cos_bar", [(False, 1e-4, 0.9999),
                                              (True, 2e-2, 0.99)])
def test_pretrain_step_matches_the_cpu(cuda, bf16, rel, cos_bar):
    """Each task's dropout-free step on the card (kernel route) against
    the CPU (plain version) from the same weights and injected masks:
    the loss, the gradients by cosine and the parameters left without a
    gradient; then one optimizer step per task on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    batch = _pretrain_batch(rng)
    cent = torch.from_numpy(rng.randn(50, 32).astype(np.float32))
    params = _pretrain_engine("cpu", bf16).init_params(0)
    res = {}
    for dev in ("cuda", "cpu"):
        eng = _pretrain_engine(dev, bf16)
        state = eng.create_state(0, params)
        res[dev] = {}
        for task in ("vis_mask", "word_mask", "matched"):
            before = attention.TRAIN_KERNEL.launches
            losses, grads = eng.loss_and_grads(
                state.model, eng.place(batch), task, cent.to(dev),
                state.generator)
            assert attention.TRAIN_KERNEL.launches - before == (
                2 + 1 + 4 * 2 if dev == "cuda" else 0)
            res[dev][task] = (float(losses["total_loss"]),
                              {n: g.double().cpu() for n, g in grads.items()
                               if g is not None})
        if dev == "cuda":
            for task in ("vis_mask", "word_mask", "matched"):
                m = eng.train_step(state, batch, task, cent.to(dev))
                assert np.isfinite(float(m["total_loss"]))
            assert state.opt.count["mask_feat"] == 1
            assert state.opt.count["bert.pooler.dense.weight"] == 1
            assert state.opt.count[
                "bert.embeddings.word_embeddings.weight"] == 3
    for task, (lc, gc) in res["cuda"].items():
        lh, gh = res["cpu"][task]
        assert gc.keys() == gh.keys()
        assert abs(lc - lh) <= rel * abs(lh), (task, lc, lh)
        dot = sum(float((gc[n] * gh[n]).sum()) for n in gc)
        norm = np.sqrt(sum(float((gc[n] ** 2).sum()) for n in gc)
                       * sum(float((gh[n] ** 2).sum()) for n in gh))
        assert dot / norm > cos_bar, (task, dot / norm)


# every (M, K, N) the int8 sampler gives the int8 dense at bench.py
# Config #2's widths (B=64, text 20, 10,000 clusters), the cluster head's
# N = 10,000 (a multiple of 8, of no tile width) included
INT8_SAMPLER_SHAPES = sorted({(M, K, N) for M, K, N, _, _ in
                              chip_smoke.sampler_dense_cases(
                                  LxmertConfig(), 64, 20, 10000)})


@pytest.mark.parametrize("M,K,N", INT8_SAMPLER_SHAPES)
@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_kernel_matches_plain_at_the_sampler_shapes(cuda, M, K, N,
                                                               static):
    _int8_check(cuda, M, K, N, static, M + K + N)


@pytest.mark.parametrize("Lq,Lk", [(20, 64), (64, 20), (20, 20), (64, 64)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_mha_blhd_kernel_at_the_sampler_batch(cuda, Lq, Lk, with_bias):
    """The int8 sampler's attention: B=64, bf16, the fast softmax."""
    rng = np.random.RandomState(Lq + 3 * Lk)
    B, H = 64, 12
    q, k, v = _qkv(rng, B, Lq, Lk, H * 64, torch.bfloat16, cuda)
    bias = None
    if with_bias:
        m = (rng.rand(B, Lk) > 0.3).astype(np.float32)
        m[:, 0] = 1
        bias = ((1.0 - torch.from_numpy(m)) * -1e9)[:, None, None, :].to(
            cuda, torch.bfloat16)
    before = attention.KERNEL.launches
    out = attention.mha_blhd(q, k, v, bias, H, fast=True)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    ref = attention.mha_blhd_reference(q, k, v, bias, H, fast=True)
    assert (out.float() - ref.float()).abs().max() <= 2e-2


@pytest.mark.parametrize("int8", [True, False])
def test_nar_decode_steps_match_the_cpu(cuda, int8):
    """The first two NAR steps of the int8 (kernels) and the bf16 sampler
    at hidden 768 on the card, against the same engine on the CPU fed
    the card's step inputs: chip_smoke phase (j)'s bars, the cluster
    logits' cosine > 0.99 and >= 90 % of cells with the card's argmax
    among the CPU's tied maxima."""
    import copy

    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.tasks import sampling

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LxmertConfig(l_layers=2, x_layers=2, r_layers=1,
                       num_clusters=1000)
    params = sampling.random_params(cfg, seed=1)
    rng = np.random.RandomState(2)
    cent = rng.randn(1000, 2048).astype(np.float32) * 0.1
    ids = torch.from_numpy(rng.randint(5, 4000, (4, 20))).long()
    ids[1, 12:] = 0
    mask = (ids > 0).float()
    steps = []

    def hook(i, inputs, logits):
        if i < 2:
            steps.append(({k: v.cpu() for k, v in inputs.items()},
                          logits.float().cpu()))

    table = torch.from_numpy(cent)
    if int8:
        eng = si.prepare_sampler_params(params, cfg, cent, cuda)
        si.calibrate_sampler(eng, table.to(cuda), ids.to(cuda),
                             mask.to(cuda), cfg)
        engine.apply_calibration(eng)
        before = int8_matmul.KERNEL.launches
        si.make_nar_sampler_int8(cfg, 4, on_step=hook)(
            eng, table.to(cuda), ids.to(cuda), mask.to(cuda))
        per = chip_smoke.sampler_launches(cfg)
        assert int8_matmul.KERNEL.launches - before == (
            per["sample lang"]["int8_dense"]
            + 4 * per["sample step"]["int8_dense"])
    else:
        eng = sampling.sampler_model(params, cfg, torch.bfloat16, cuda)
        sampling.make_nar_sampler(eng, 4, on_step=hook)(
            table.to(cuda), ids.to(cuda), mask.to(cuda))
    host = copy.deepcopy(eng).to("cpu")
    pos = sampling.grid_positions(8, 4, "cpu", torch.bfloat16 if int8
                                  else torch.float32)
    with torch.inference_mode():
        for step_in, card in steps:
            if int8:
                got = si._predict_forward(host, ids, step_in["feats"], pos,
                                          mask, 12)
            else:
                got = host(ids, step_in["code"], pos, attention_mask=mask,
                           vis_mask=step_in["vis_mask"].float(),
                           centroids=table.to(torch.bfloat16),
                           heads=("obj",))["obj_logits"]
            assert chip_smoke.cosine(card, got) > 0.99
            assert chip_smoke.tie_aware_agreement(card, got) >= 0.9


def test_fused_mha_grad_check_does_not_depend_on_the_phase_order(cuda):
    """chip_smoke's C1 check after the sampler cases have drawn from the
    same generator first (the order that failed when the fp32 bias
    gradient was held to 1e-4): the bf16 bias's gradient is held element
    by element to 2^-7 |r| plus its sum's fp32 accumulation bound,
    whatever the generator's state. The kernel-phase timers are
    replaced: only the draws matter here."""
    cfg = LxmertConfig()
    sz = chip_smoke.SAMPLE_SIZES
    rng = torch.Generator(device="cuda").manual_seed(0)
    saved = chip_smoke.queued_ms, chip_smoke.time_ms
    chip_smoke.queued_ms = lambda torch_, fn: (fn(), (1.0, True))[1]
    chip_smoke.time_ms = lambda torch_, fn: (fn(), 1.0)[1]
    try:
        chip_smoke.check_attention(
            torch, torch.nn.functional, attention, cfg, rng, lambda m: None,
            cases=chip_smoke.sampler_attention_cases(cfg, sz["batch"],
                                                     sz["text"]))
        chip_smoke.check_int8(
            torch, int8_matmul, quant, cfg, chip_smoke.BATCH,
            3129, rng, lambda m: None,
            cases=chip_smoke.sampler_dense_cases(cfg, sz["batch"],
                                                 sz["text"],
                                                 sz["clusters"]))
    finally:
        chip_smoke.queued_ms, chip_smoke.time_ms = saved
    rows = chip_smoke.check_fused_mha_grad(torch, attention, ffn, cfg, rng,
                                           lambda m: None)
    fp32 = [r for r in rows if r["dtype"] == "float32"]
    assert len(fp32) == 2
    assert all(r["bias_bar"]["excess"] <= 0 for r in fp32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gan_steps_match_the_cpu(cuda, dtype):
    """One D-step and one G-step of the GAN trainer on the card against
    the same steps on the CPU from the same fresh state and batch, at a
    small width (64 px, base 16, 50 classes, B=4): the losses, the
    gradients' cosine (Adam's mu; noise scales apart, their gradients
    come from each device's draw) and the u, v written back. fp32 (TF32
    off): chip_smoke's GAN_STEP_BARS and GAN_SN_TOL; bf16 (the same
    bf16 convolutions summed in another order, and the CPU's fp32
    product of the bf16 ACGAN operands): losses within 2e-2 relative,
    cosine > 0.99, u, v within 1e-5 (computed from the fp32 weights)."""
    from xlxmert_tpu_torch.core.config import GanConfig

    sizes = dict(batch=4, target=64, grid=8, emb=64, classes=50, g_base=16,
                 d_base=16, codebook=32)
    batch, centroids = chip_smoke.gan_inputs(sizes, 0)
    cfg = GanConfig(emb_dim=64, codebook_dim=32, g_base_dim=16,
                    d_base_dim=16, target_size=64, n_classes=50,
                    batch_size=4, mixed_precision=dtype == "bfloat16")
    bars = chip_smoke.GAN_STEP_BARS, chip_smoke.GAN_SN_TOL
    if dtype == "bfloat16":
        chip_smoke.GAN_STEP_BARS, chip_smoke.GAN_SN_TOL = (2e-2, 0.99), 1e-5
    try:
        out = chip_smoke.gan_steps_card_vs_cpu(torch, cfg, batch, centroids,
                                               0, "cuda", lambda m: None)
    finally:
        chip_smoke.GAN_STEP_BARS, chip_smoke.GAN_SN_TOL = bars
    assert set(out["grad_cosine"]) == {"d", "g"}
    assert "d_cls_loss" in out["loss_rel_diff"]


@pytest.fixture
def no_tf32():
    with chip_smoke.tf32_off(torch):
        yield


def test_kmeans_step_matches_the_cpu(cuda, no_tf32):
    """One assignment and Lloyd step (N=4,096, K=256, D=256) on the card
    and on the CPU from the same centroids: chip_smoke (l)'s tie-aware
    bars (kmeans_agreement); the chunked step equals the one-shot."""
    from xlxmert_tpu_torch.vocab import kmeans

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, 256, generator=g)
    c0 = x[torch.randperm(4096, generator=g)[:256]]
    runs = {}
    for where in ("cuda", "cpu"):
        ids, _ = kmeans._assign_chunk(x.to(where), c0.to(where))
        cent, inert = kmeans.lloyd_step(x.to(where), c0.to(where), 256)
        runs[where] = {"ids": ids.cpu().numpy(),
                       "centroids": cent.cpu().numpy(),
                       "inertia": float(inert)}
    chk = chip_smoke.kmeans_agreement(x.numpy(), c0.numpy(), runs["cuda"],
                                      runs["cpu"])
    assert chk["failures"] == [], chk
    cent, inert = kmeans.lloyd_step_chunked(
        x.cuda(), torch.ones(4096, device="cuda"), c0.cuda(), 256, 1024)
    np.testing.assert_allclose(cent.cpu().numpy(), runs["cuda"]["centroids"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid,level", [(8, 2), (4, 3), (2, 4), (1, 5)])
def test_tiny_grid_extractor_matches_the_cpu(cuda, no_tf32, grid, level):
    """The tiny Detectron grid extractor, fp32 with TF32 off, on the card
    and the CPU from the same tree: cosine >= 0.99999, max |d| <= 1e-4
    max |ref|; its grid boxes over 470x630 images pooled from P2..P5, one
    level for each grid size."""
    from xlxmert_tpu_torch.cli.extract_features import extract_batch
    from xlxmert_tpu_torch.models import detectron as det

    cfg = det.tiny_detectron_config()
    tree = det.random_params(cfg, 0)
    imgs, sizes = chip_smoke.factory_images(2, (480, 640), (470, 630), 0)
    lv = det.fpn_level_assignment(det.grid_boxes(470, 630, grid))
    assert set((lv + 2).tolist()) == {level}
    out = {}
    for where in ("cuda", "cpu"):
        m = det.load_params(det.DetectronGridExtractor(cfg, grid), tree)
        out[where] = torch.from_numpy(extract_batch(m.to(where).eval(),
                                                    imgs, sizes, where))
    a = chip_smoke.agreement(torch, out["cuda"], out["cpu"])
    assert a["cosine"] >= 0.99999 and a["max_rel"] <= 1e-4, a


def test_tiny_detector_matches_the_cpu(cuda, no_tf32):
    """The tiny detector on the card against the CPU, unit by unit from
    the card's own inputs, as chip_smoke (l): the RPN outputs by cosine,
    the proposal stage's ids (near-tie swaps aside), the box head's
    class scores, fc6 and fc7 by cosine, the selection's kept indices
    and obj_id exactly."""
    from xlxmert_tpu_torch.models import detectron as det
    from xlxmert_tpu_torch.ops.box_selection import select_top_features

    cfg = det.tiny_detectron_config()
    tree = det.random_params(cfg, 0, n_classes=31)
    models = {w: det.load_params(det.DetectronDetector(
        cfg, n_classes=31, pre_nms_top_n=200, post_nms_top_n=200,
        fpn_post_nms_top_n=150), tree).to(w).eval() for w in ("cuda", "cpu")}
    imgs, sizes = chip_smoke.factory_images(2, (128, 160), (120, 150), 1)
    x, s = torch.from_numpy(imgs), torch.from_numpy(sizes)
    with torch.inference_mode():
        fa, la, da = models["cuda"].rpn_outputs(x.cuda())
        fr, lr, dr = models["cpu"].rpn_outputs(x)
        for got, ref in ((fa, fr), (la, lr), (da, dr)):
            a = chip_smoke.agreement(torch, got, ref)
            assert a["cosine"] >= 0.99999 and a["max_rel"] <= 1e-4, a
        pa = models["cuda"].propose(la, da, s.cuda())
        pr = models["cpu"].propose([t.cpu() for t in la],
                                   [t.cpu() for t in da], s)
        chk = chip_smoke._proposal_ids_agree(pa, pr)
        assert chk["mismatches"] == [] and chk["valid_equal"], chk
        cls, feats = models["cuda"].box_head(fa, pa["boxes"])
        cr, fr_ = models["cpu"].box_head([t.cpu() for t in fa],
                                         pa["boxes"].cpu())
        for got, ref in ((cls, cr), (feats["fc6"], fr_["fc6"]),
                         (feats["fc7"], fr_["fc7"])):
            a = chip_smoke.agreement(torch, got, ref)
            assert a["cosine"] >= 0.99999 and a["max_rel"] <= 1e-4, a
        inputs = (pa["boxes"], cls, feats["fc6"], torch.ones(2).cuda(),
                  torch.isfinite(pa["scores"]))
        sel = {w: select_top_features(*(t.to(w) for t in inputs[:4]),
                                      valid=inputs[4].to(w),
                                      num_features=10)
               for w in ("cuda", "cpu")}
    for k in ("keep_boxes", "obj_id", "num_boxes"):
        assert torch.equal(sel["cuda"][k].cpu(), sel["cpu"][k]), k
