"""Gradients through the port's forward kernels, against the JAX package.

`fused_mha` has a custom_vjp in the JAX package (the einsum recomputed):
the port's gradients for q, k, v and a bias that requires grad are held
to `jax.grad` through the JAX `fused_mha` (Pallas in interpret mode on
the CPU, as tests/test_pallas_attention.py runs it). `mha_blhd`,
`mha_hbatch` and `fused_ffn` have no vjp there, and `jax.grad` through
them raises: the port's forward runs under grad and its backward
raises. With grad off (`inference_mode`) the wrappers are called
directly, so a serving forward is bit for bit what the plain versions
give.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.ops.attention import fused_mha as jax_fused_mha
from xlxmert_tpu.ops.attention import mha_blhd as jax_mha_blhd
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.models import lxmert
from xlxmert_tpu_torch.models.lxmert import ServingOptions
from xlxmert_tpu_torch.models.task_heads import VQAModel
from xlxmert_tpu_torch.ops import attention, ffn

B, H, D = 2, 2, 64
# fp32: sums in another order; bf16: products and sums rounded to bf16
# on both sides, accumulated in another order
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _operands(Lq, Lk, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32)
               for L in (Lq, Lk, Lk))
    bias = (0.5 * rng.randn(B, Lk)).astype(np.float32)
    bias[1, Lk // 2:] = -1e9   # padded keys, as the serving mask gives
    g = rng.randn(B, H, Lq, D).astype(np.float32)
    return q, k, v, bias, g


def _jax_vjp(q, k, v, bias, g, fast, dt):
    """The JAX fused_mha's output and its gradients for q, k, v (and the
    bias when given) under the cotangent g, in dt."""
    jdt = getattr(jnp, dt)
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    if bias is not None:
        out, vjp = jax.vjp(lambda q, k, v, b: jax_fused_mha(q, k, v, b, fast),
                           *args, jnp.asarray(bias, jdt))
    else:
        out, vjp = jax.vjp(lambda q, k, v: jax_fused_mha(q, k, v, None,
                                                         fast), *args)
    return [np.asarray(a, np.float32) for a in (out, *vjp(jnp.asarray(g,
                                                                   jdt)))]


def _port_vjp(q, k, v, bias, g, fast, dtype):
    """The port's fused_mha (its autograd Function on the CPU) likewise;
    with dtype float64, the exact gradients of einsum_mha_reference."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in ((q, k, v) if bias is None else (q, k, v, bias))]
    fn = (attention.einsum_mha_reference if dtype == torch.float64
          else attention.fused_mha)
    out = fn(*leaves[:3], None if bias is None else leaves[3], fast)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(dtype))
    for t in leaves:
        assert t.grad.dtype == dtype
    return [a.detach().double().numpy() for a in
            (out, *(t.grad for t in leaves))]


@pytest.mark.parametrize("dt,fast", [("float32", False), ("float32", True),
                                     ("bfloat16", False)])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(20, 20), (7, 13), (13, 7)])
def test_fused_mha_gradients_match_jax(Lq, Lk, with_bias, dt, fast):
    """The output and the gradients of q, k, v and a bias that requires
    grad, against jax.vjp through the JAX fused_mha: 1e-5 in fp32, 2e-2
    in bf16 (the softmax in fp32 there, as the JAX default fast=False)."""
    q, k, v, bias, g = _operands(Lq, Lk, Lq * 100 + Lk)
    bias = bias if with_bias else None
    ref = _jax_vjp(q, k, v, bias, g, fast, dt)
    got = _port_vjp(q, k, v, bias, g, fast, getattr(torch, dt))
    assert len(got) == len(ref) == 4 + with_bias
    for name, a, r in zip(("out", "q", "k", "v", "bias"), got, ref):
        np.testing.assert_allclose(a, r, atol=TOL[dt], rtol=TOL[dt],
                                   err_msg=name)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(20, 20), (7, 13), (13, 7)])
def test_fused_mha_bf16_fast_gradients_match_jax(Lq, Lk, with_bias):
    """bf16 with the softmax in bf16 (fast, the serving model's): each
    framework rounds the scores, the softmax's steps and its backward's
    to bf16 at its own points, and the bias gradient sums H * Lq of them
    (JAX's in bf16), so neither lies within 2e-2 of the other everywhere
    (up to 0.19 apart at |grad| ~ 6-9). Held instead to the exact
    (float64) gradients: the port's output and gradients are no further
    from them than JAX's, by more than 2e-2, and point the same way as
    JAX's (cosine > 0.999)."""
    q, k, v, bias, g = _operands(Lq, Lk, Lq * 100 + Lk)
    bias = bias if with_bias else None
    ref = _jax_vjp(q, k, v, bias, g, True, "bfloat16")
    got = _port_vjp(q, k, v, bias, g, True, torch.bfloat16)
    exact = _port_vjp(q, k, v, bias, g, False, torch.float64)
    for name, a, r, e in zip(("out", "q", "k", "v", "bias"), got, ref,
                             exact):
        assert np.abs(a - e).max() <= np.abs(r - e).max() + TOL[
            "bfloat16"], name
        cos = (a.ravel() @ r.ravel()) / (np.linalg.norm(a)
                                         * np.linalg.norm(r))
        assert cos > 0.999, (name, cos)


def test_fused_mha_gradient_leaves_an_untracked_bias_alone():
    """Gradients for the operands that require grad only: a bias that
    does not (the model's mask) gets none, as the JAX bias gradient is
    simply dropped there."""
    q, k, v, bias, g = _operands(9, 11, 3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = torch.from_numpy(bias)
    attention.fused_mha(*leaves, tb, False).backward(torch.from_numpy(g))
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    attention.einsum_mha_reference(*ref, tb, False).backward(
        torch.from_numpy(g))
    assert tb.grad is None
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=0, rtol=0)


def _blhd_operands(seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, L, H * D).astype(np.float32))
               .to(dtype) for L in (9, 12, 12))
    bias = torch.zeros(B, 1, 1, 12)
    bias[1, ..., 8:] = -1e9
    return q, k, v, bias.to(torch.bfloat16)


def _ffn_operands(seed):
    rng = np.random.RandomState(seed)
    Hd, I = 48, 128

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32))

    return (t(5, Hd), t(I, Hd, scale=0.05), t(I, scale=0.02),
            t(Hd, I, scale=0.05), t(Hd, scale=0.02), 1.0 + t(Hd, scale=0.1),
            t(Hd, scale=0.02))


# each forward-only kernel's wrapper, its operands, and which of them a
# caller may differentiate (every float operand, the weights included)
FORWARD_ONLY = {
    "mha_blhd": (lambda *a: attention.mha_blhd(*a, H, True),
                 lambda: _blhd_operands(1), (0, 1, 2)),
    "mha_hbatch": (lambda *a: attention.mha_hbatch(*a, H),
                   lambda: _blhd_operands(2, torch.bfloat16), (0, 1, 2)),
    "fused_ffn": (ffn.fused_ffn, lambda: _ffn_operands(3),
                  (0, 1, 2, 3, 4, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(FORWARD_ONLY))
def test_forward_only_kernels_refuse_a_backward(name):
    """The forward runs under grad and gives what it gives with grad off,
    bit for bit; the backward raises, whichever operand required grad
    (the input, or a weight only). The JAX counterparts raise under
    jax.grad, as shown here for mha_blhd."""
    fn, make, diff = FORWARD_ONLY[name]
    with torch.inference_mode():
        want = fn(*make())
    assert want.grad_fn is None
    for which in (diff, diff[-1:]):
        args = list(make())
        for i in which:
            args[i].requires_grad_()
        out = fn(*args)
        assert out.requires_grad and out.grad_fn is not None
        torch.testing.assert_close(out.detach(), want, atol=0, rtol=0)
        with pytest.raises(RuntimeError, match=f"{name} has no gradient"):
            out.float().sum().backward()
    if name == "mha_blhd":
        q, k, v, _ = (jnp.asarray(t.float().numpy())
                      for t in _blhd_operands(1))
        with pytest.raises(ValueError, match="Linearization failed"):
            jax.grad(lambda q: jax_mha_blhd(q, k, v, None, H).sum())(q)


@pytest.mark.parametrize("attention_route,fused", [("blhd", True),
                                                   ("pallas", True)])
def test_serving_forward_under_inference_mode_is_unchanged(
        monkeypatch, attention_route, fused):
    """A bf16 serving model whose parameters require grad (as built):
    under inference_mode its output is, bit for bit, what the plain
    versions of its kernels give, and carries no history; with grad on,
    the same forward gives the same bits."""
    cfg = LxmertConfig(vocab_size=101, hidden_size=128,
                       num_attention_heads=2, intermediate_size=256,
                       l_layers=2, x_layers=1, r_layers=1,
                       visual_feat_dim=24)
    model = VQAModel(cfg, 7, torch.bfloat16,
                     ServingOptions(True, attention_route, fused))
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
            p.copy_(1.0 + 0.1 * noise if "norm.weight" in name.lower()
                    else 0.05 * noise)
    model = model.to(torch.bfloat16).eval()
    assert all(p.requires_grad for p in model.parameters())
    ids = torch.from_numpy(rng.randint(1, 101, size=(3, 12)))
    mask = torch.ones(3, 12)
    mask[0, 9:] = 0
    feats = torch.from_numpy(rng.randn(3, 16, 24).astype(np.float32))
    pos = torch.from_numpy(rng.rand(3, 16, 4).astype(np.float32))

    def run():
        return model(ids, feats, pos, attention_mask=mask)

    with torch.inference_mode():
        served = run()
    assert served.grad_fn is None
    with torch.enable_grad():
        tracked = run()
    assert tracked.grad_fn is not None
    torch.testing.assert_close(tracked.detach(), served, atol=0, rtol=0)
    # the plain versions in place of the kernels' wrappers
    monkeypatch.setattr(lxmert, "mha_blhd", attention.mha_blhd_reference)
    monkeypatch.setattr(lxmert, "fused_mha", attention.fused_mha_reference)
    monkeypatch.setattr(lxmert, "fused_ffn", ffn.fused_ffn_reference)
    with torch.inference_mode():
        plain = run()
    torch.testing.assert_close(served, plain, atol=0, rtol=0)
