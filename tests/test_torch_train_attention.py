"""Port's training attention (`ops/attention.mha_blhd_train`: plain
forward on the CPU, autograd backward) against the JAX package's
`mha_blhd_train` (Pallas forward in interpret mode on the CPU, einsum
recompute backward), and the model's two training attention routes.

Dropout bits differ between the frameworks by design: the tests inject
the same mask into both, or set the rates to 0."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.ops.attention import mha_blhd_train as jax_train
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.models.lxmert import (
    LxmertModel, train_attention_mode,
)
from xlxmert_tpu_torch.ops import attention
from xlxmert_tpu_torch.ops.attention import (
    blhd_einsum_reference, mha_blhd_train, mha_blhd_train_reference,
)

H, D = 4, 16


def _inputs(B, Lq, Lk, with_bias, with_mask, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Lq, H * D).astype(np.float32)
    k = rng.randn(B, Lk, H * D).astype(np.float32)
    v = rng.randn(B, Lk, H * D).astype(np.float32)
    bias = mask = None
    if with_bias:
        bias = np.zeros((B, 1, 1, Lk), np.float32)
        bias[:, ..., Lk - 3:] = -1e9
    if with_mask:
        keep = rng.rand(B, H, Lq, Lk) < 0.9
        mask = keep.astype(np.float32) / np.float32(0.9)
    return q, k, v, bias, mask


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(8, 12), (12, 8)])
def test_plain_forward_matches_jax_kernel_fp32(Lq, Lk, with_bias,
                                               with_mask):
    """fp32: the tolerance of test_pallas_attention.py's train kernel."""
    q, k, v, bias, mask = _inputs(4, Lq, Lk, with_bias, with_mask,
                                  Lq * 7 + Lk)
    ref = np.asarray(jax_train(_j(q), _j(k), _j(v), _j(bias), _j(mask), H,
                               False))
    out = mha_blhd_train(_t(q), _t(k), _t(v), _t(bias), _t(mask), H)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        mha_blhd_train_reference(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                                 H).numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_forward_matches_jax_kernel_bf16(with_mask):
    """bf16 inputs, a bf16 mask (keep / bf16(0.9), as the model forms
    it) applied to the bf16 probabilities: the same rounding points; the
    sums' order differs (atol 2e-2, the serving kernel's bf16 bar)."""
    q, k, v, bias, _ = _inputs(4, 20, 12, True, False, 3)
    mask = None
    if with_mask:
        keep = jax.random.bernoulli(jax.random.PRNGKey(4), 0.9,
                                    (4, H, 20, 12))
        mask = np.asarray(keep.astype(jnp.bfloat16)
                          / jnp.asarray(0.9, jnp.bfloat16), np.float32)
    bf = jnp.bfloat16
    ref = np.asarray(jax_train(_j(q, bf), _j(k, bf), _j(v, bf),
                               _j(bias, bf), _j(mask, bf), H, False),
                     np.float32)
    tb = torch.bfloat16
    out = mha_blhd_train(_t(q, tb), _t(k, tb), _t(v, tb), _t(bias, tb),
                         _t(mask, tb), H)
    assert out.dtype == tb
    np.testing.assert_allclose(out.float().detach().numpy(), ref,
                               atol=2e-2)


def test_backward_matches_jax_grad():
    """The autograd Function's q/k/v gradients (einsum recompute with the
    saved mask) against jax.grad of the JAX op (atol 1e-4, as in
    test_pallas_attention.py); none for the bias and the mask."""
    q, k, v, bias, mask = _inputs(2, 8, 12, True, True, 6)

    def jloss(q, k, v):
        return (jax_train(q, k, v, _j(bias), _j(mask), H, False) ** 2).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tbias, tmask = _t(bias).requires_grad_(), _t(mask).requires_grad_()
    out = mha_blhd_train(tq, tk, tv, tbias, tmask, H)
    (out ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    assert tbias.grad is None and tmask.grad is None
    # the same gradients as autograd through the einsum formulation
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    (blhd_einsum_reference(*leaves, _t(bias), _t(mask), H) ** 2
     ).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_cpu_forward_never_counts_a_launch():
    q, k, v, bias, mask = _inputs(2, 5, 5, True, True, 1)
    before = attention.TRAIN_KERNEL.launches
    mha_blhd_train(_t(q), _t(k), _t(v), _t(bias), _t(mask), H)
    assert attention.TRAIN_KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        mha_blhd_train(*(_t(a).to("meta") for a in (q, k, v)), None, None,
                       H)


CFG = dict(vocab_size=100, hidden_size=64, num_attention_heads=4,
           intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
           visual_feat_dim=16)


def _model(route, **rates):
    torch.manual_seed(0)
    m = LxmertModel(LxmertConfig(**CFG, **rates), train_attention=route)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.randn(p.shape) * (0.05 if p.dim() > 1 else 0.02)
                    + (1.0 if name.endswith("LayerNorm.weight")
                       or name.endswith("layer_norm.weight") else 0.0))
    return m


def _batch(seed=9):
    rng = np.random.RandomState(seed)
    B, T, V = 2, 8, 9
    ids = torch.from_numpy(rng.randint(1, 100, (B, T)))
    mask = torch.ones(B, T)
    mask[1, T - 2:] = 0.0
    feats = torch.from_numpy(rng.randn(B, V, 16).astype(np.float32))
    pos = torch.from_numpy(rng.rand(B, V, 4).astype(np.float32))
    return ids, feats, pos, mask


def test_train_attention_mode_resolves_auto_to_xla():
    assert train_attention_mode("auto") == "xla"
    assert train_attention_mode("pallas_blhd") == "pallas_blhd"
    with pytest.raises(ValueError):
        train_attention_mode("einsum")


def test_routes_agree_at_rate_0_in_loss_and_grads():
    """The training forward through "pallas_blhd" (mha_blhd_train) and
    "xla" (einsum) with the dropout rates at 0: the same loss and
    parameter gradients (the JAX package's test, :221-264)."""
    ids, feats, pos, mask = _batch()
    out = {}
    for route in ("xla", "pallas_blhd"):
        m = _model(route, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0).train()
        lang, vis, pooled = m(ids, feats, pos, attention_mask=mask,
                              generator=torch.Generator().manual_seed(3))
        loss = (pooled ** 2).mean() + (lang ** 2).mean() + (vis ** 2).mean()
        loss.backward()
        out[route] = (float(loss.detach()), {n: p.grad.clone()
                                    for n, p in m.named_parameters()
                                    if p.grad is not None})
    (l0, g0), (l1, g1) = out["xla"], out["pallas_blhd"]
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    assert g0.keys() == g1.keys() and len(g0) > 20
    for n in g0:
        np.testing.assert_allclose(g0[n].numpy(), g1[n].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_dropout_draws_from_the_generator_and_eval_is_unaffected():
    """With attention-prob dropout > 0 the kernel route drops: two
    generator seeds differ, the same seed repeats, and the eval forward
    is bit-equal between the two routes and needs no generator."""
    ids, feats, pos, _ = _batch(10)
    m = _model("pallas_blhd", hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.5).train()

    def pooled(seed):
        return m(ids, feats, pos,
                 generator=torch.Generator().manual_seed(seed))[2]

    o1, o1b, o2 = pooled(1), pooled(1), pooled(2)
    assert torch.equal(o1, o1b)
    assert not torch.allclose(o1, o2)
    with pytest.raises(RuntimeError, match="Generator"):
        m(ids, feats, pos)
    e1 = m.eval()(ids, feats, pos)[2]
    e0 = _model("xla", hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.5).eval()(ids, feats, pos)[2]
    assert torch.equal(e1, e0)
