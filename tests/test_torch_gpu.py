"""Card-only checks of the port's CUDA kernels against their plain
PyTorch versions, at the serving and training paths' shapes and at
ragged ones.

Marked `gpu`; each test skips from its fixture when no CUDA device is
present. This file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from xlxmert_tpu_torch.ops import attention, fused_block, ffn, int8_matmul
from xlxmert_tpu_torch.ops.quant import quantize_weight, with_activation_scale

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


@pytest.mark.parametrize("Lq,Lk", [(20, 20), (64, 64), (20, 64), (64, 20),
                                   (8, 8), (7, 33)])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype,fast,tol", [
    (torch.bfloat16, True, 2e-2),   # bf16 scores/softmax: rounding order
    (torch.bfloat16, False, 2e-2),  # bf16 out
    (torch.float32, False, 1e-5),   # fp32 sums in another order
])
def test_mha_blhd_kernel_matches_plain(cuda, Lq, Lk, with_bias, dtype,
                                       fast, tol):
    rng = np.random.RandomState(Lq * 100 + Lk)
    B, H, D = 6, 12, 64
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
    of mha_blhd, which computes the same function."""
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
    for other in (ref, attention.mha_blhd(q, k, v, bias, H, fast=True)):
        err = (out.float() - other.float()).abs().max().item()
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
    rng = np.random.RandomState(M + K + N)
    qw = quantize_weight(rng.randn(K, N).astype(np.float32) * 0.05,
                         rng.randn(N).astype(np.float32) * 0.1).to(cuda)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32) * 2).to(
        cuda, torch.bfloat16)
    inv_a, col = None, qw.scale
    if static:
        from xlxmert_tpu_torch.ops.quant import with_activation_scale

        with_activation_scale(qw, 0.8 * x.float().abs().max().item())
        inv_a, col = qw.inv_a, qw.out_scale
    before = int8_matmul.KERNEL.launches
    out = int8_matmul.int8_dense_fused(x, qw.w_i8, col, qw.bias, inv_a)
    torch.cuda.synchronize()
    assert int8_matmul.KERNEL.launches == before + 1
    ref = int8_matmul.int8_dense_reference(x, qw.w_i8, col, qw.bias, inv_a)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


def test_int8_dense_kernel_rejects_what_it_cannot_take(cuda):
    qw = quantize_weight(np.ones((24, 8), np.float32)).to(cuda)
    x = torch.zeros(4, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul.int8_dense_fused(x, qw.w_i8, qw.scale)
    qw = quantize_weight(np.ones((32, 8), np.float32)).to(cuda)
    x = torch.zeros(4, 32, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        int8_matmul.int8_dense_fused(x, qw.w_i8, qw.scale)


@pytest.mark.parametrize("Lq,Lk", [(20, 20), (64, 64), (8, 64), (64, 12),
                                   (7, 33)])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype,fast,tol", [
    (torch.bfloat16, True, 2e-2),   # bf16 scores/softmax: rounding order
    (torch.float32, False, 1e-5),   # fp32 sums in another order
])
@pytest.mark.parametrize("views", [False, True])
def test_fused_mha_kernel_matches_plain(cuda, Lq, Lk, with_bias, dtype,
                                        fast, tol, views):
    """(B, H, L, D) operands, contiguous or head-transposed views of the
    projections (the model's "pallas" route); (B, Lk) bf16 bias."""
    rng = np.random.RandomState(Lq * 100 + Lk + 7)
    B, H, D = 6, 12, 64
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
