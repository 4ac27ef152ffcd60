"""Port's attention (plain versions, CPU) against the JAX package's
`ops.attention.mha_blhd` and `fused_mha` (Pallas, interpret mode on the
CPU)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from xlxmert_tpu.ops.attention import fused_mha as jax_fused_mha
from xlxmert_tpu.ops.attention import mha_blhd as jax_mha_blhd
from xlxmert_tpu_torch.ops.attention import (
    fused_mha, fused_mha_reference, mha_blhd, mha_blhd_reference,
)

H, D, B = 4, 16, 2


def _inputs(Lq, Lk, with_bias, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Lq, H * D).astype(np.float32)
    k = rng.randn(B, Lk, H * D).astype(np.float32)
    v = rng.randn(B, Lk, H * D).astype(np.float32)
    bias = None
    if with_bias:
        bias = np.zeros((B, 1, 1, Lk), np.float32)
        bias[1, ..., Lk - 2:] = -1e9
    return q, k, v, bias


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(7, 7), (5, 9), (9, 5)])
def test_mha_blhd_fp32_matches_jax(Lq, Lk, with_bias):
    """fast=False in fp32: the tolerance of test_pallas_attention.py."""
    q, k, v, bias = _inputs(Lq, Lk, with_bias, Lq * 10 + Lk)
    ref = np.asarray(jax_mha_blhd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), H, fast=False))
    out = mha_blhd(*(torch.from_numpy(a) for a in (q, k, v)),
                   None if bias is None else torch.from_numpy(bias), H,
                   fast=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(7, 7), (5, 9), (9, 5)])
def test_mha_blhd_bf16_fast_matches_jax(Lq, Lk, with_bias):
    """fast=True in bf16 (the serving numerics): bf16 scores and softmax
    round at the same points; the sums' order differs (atol 2e-2)."""
    q, k, v, bias = _inputs(Lq, Lk, with_bias, Lq * 10 + Lk + 1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias, jnp.bfloat16)
    ref = np.asarray(jax_mha_blhd(jq, jk, jv, jb, H, fast=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).to(torch.bfloat16)
    out = mha_blhd(tq, tk, tv, tb, H, fast=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def test_mha_blhd_takes_column_slices_of_a_fused_projection():
    """The engine passes q/k/v as views of one (B, L, 3*H*D) tensor."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(B, 6, 3 * H * D).astype(np.float32))
    q, k, v = qkv.split(H * D, dim=-1)
    out = mha_blhd(q, k, v, None, H, fast=False)
    ref = mha_blhd_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                             None, H, fast=False)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert out.shape == (B, 6, H * D) and out.is_contiguous()


def _heads(Lq, Lk, with_bias, seed):
    """(B, H, L, D) operands and a (B, Lk) bias, as fused_mha takes them."""
    q, k, v, bias = _inputs(Lq, Lk, with_bias, seed)
    q, k, v = (a.reshape(B, -1, H, D).transpose(0, 2, 1, 3).copy()
               for a in (q, k, v))
    return q, k, v, None if bias is None else bias.reshape(B, Lk)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(7, 7), (5, 9)])
def test_fused_mha_fp32_matches_jax(Lq, Lk, with_bias, fast):
    """fp32 (fast only lowers the softmax type, which is fp32 here too):
    sums in another order, tolerance 1e-5."""
    q, k, v, bias = _heads(Lq, Lk, with_bias, Lq * 10 + Lk + 2)
    ref = np.asarray(jax_fused_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), fast))
    out = fused_mha(*(torch.from_numpy(a) for a in (q, k, v)),
                    None if bias is None else torch.from_numpy(bias), fast)
    assert out.shape == (B, H, Lq, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_mha_bf16_matches_jax(with_bias, fast):
    """bf16: the scores round to bf16 (fast) or stay fp32, at the same
    points on both sides; the sums' order differs (atol 2e-2)."""
    q, k, v, bias = _heads(9, 5, with_bias, 4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias, jnp.bfloat16)
    ref = np.asarray(jax_fused_mha(jq, jk, jv, jb, fast), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).to(torch.bfloat16)
    out = fused_mha(tq, tk, tv, tb, fast)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def test_fused_mha_takes_head_transposed_views():
    """The model's "pallas" route passes (B, L, H, D) -> (B, H, L, D)
    views of the projections, not copies; the result is contiguous and
    equals the packed-head version's."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(B, 6, H * D).astype(np.float32))
               for _ in range(3))
    views = [t.view(B, 6, H, D).transpose(1, 2) for t in (q, k, v)]
    out = fused_mha(*views, None, fast=False)
    ref = fused_mha_reference(*(t.contiguous() for t in views), None)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert out.is_contiguous()
    torch.testing.assert_close(
        out.transpose(1, 2).reshape(B, 6, H * D),
        mha_blhd_reference(q, k, v, None, H, fast=False), atol=0, rtol=0)
