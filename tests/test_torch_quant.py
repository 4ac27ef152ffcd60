"""Port's int8 quantization and dense (plain version, CPU) against the
JAX package's ops/quant.py and ops/int8_matmul.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.ops import quant as jq
from xlxmert_tpu.ops.int8_matmul import int8_dense_fused as jax_fused
from xlxmert_tpu_torch.ops import quant as tq
from xlxmert_tpu_torch.ops.int8_matmul import int8_dense_fused


def _weights(K, N, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-8 scale floor
    return w, (rng.randn(N) * 0.1).astype(np.float32)


def _x(M, K, seed):
    x = np.random.RandomState(seed).randn(M, K).astype(np.float32) * 2
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("K,N", [(48, 32), (64, 17)])
def test_quantize_weight_is_byte_identical(K, N):
    w, b = _weights(K, N, K + N)
    ref = jq.quantize_weight(w, b)
    got = tq.quantize_weight(w, b)
    assert got.w_i8.shape == (N, K) and got.w_i8.dtype == torch.int8
    assert np.asarray(ref.w_i8).tobytes() == got.w_i8.numpy().T.tobytes()
    assert np.asarray(ref.scale).tobytes() == got.scale.numpy().tobytes()
    assert np.asarray(ref.bias).tobytes() == got.bias.numpy().tobytes()


@pytest.mark.parametrize("M,K,N", [(16, 48, 32), (9, 64, 17)])
def test_dynamic_dense_matches_jax_int8_dense(M, K, N):
    """Same row scales and int8 rows, equal int32 accumulators; the bf16
    output within atol 1e-2."""
    w, b = _weights(K, N, M)
    x = _x(M, K, M + 1)
    jqw, tqw = jq.quantize_weight(w, b), tq.quantize_weight(w, b)
    jx8, js = jq.quantize_rows(jnp.asarray(x))
    tx8, ts = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tx8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jacc = jax.lax.dot_general(jx8, jqw.w_i8, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tacc = tq.int8_accumulate(tx8, tqw.w_i8)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    ref = np.asarray(jq.int8_dense(jnp.asarray(x), jqw), np.float32)
    got = int8_dense_fused(torch.from_numpy(x), tqw.w_i8, tqw.scale,
                           tqw.bias)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2)
    np.testing.assert_allclose(tq.int8_matmul(tx8, ts, tqw).float().numpy(),
                               ref, atol=1e-2)


@pytest.mark.parametrize("M,K,N", [(16, 48, 32), (9, 64, 17)])
def test_dynamic_dense_matches_jax_fused_kernel(M, K, N):
    """Against the TPU kernel (interpret mode). It multiplies by 1/s where
    the port divides by s (the engine's default path), so an activation
    at a .5 boundary may land one int8 step away: each output may differ
    by one quantum per flipped element, s_row * |w_i8| * scale."""
    w, b = _weights(K, N, M + 2)
    x = _x(M, K, M + 3)
    jqw, tqw = jq.quantize_weight(w, b), tq.quantize_weight(w, b)
    ref = np.asarray(jax_fused(jnp.asarray(x), jqw.w_i8, jqw.scale,
                               jqw.bias), np.float32)
    got = int8_dense_fused(torch.from_numpy(x), tqw.w_i8, tqw.scale,
                           tqw.bias).float().numpy()
    s = np.abs(x).max(1, keepdims=True) / 127.0
    quantum = s * np.abs(w).max(0)[None, :]
    bf16_step = np.abs(ref) * 2.0 ** -7
    assert (np.abs(got - ref) <= quantum + bf16_step + 1e-6).all()


@pytest.mark.parametrize("M,K,N", [(16, 48, 32), (9, 64, 17)])
def test_static_dense_matches_jax_int8_dense_static(M, K, N):
    w, b = _weights(K, N, M + 4)
    x = _x(M, K, M + 5)
    a_max = 0.7 * float(np.abs(x).max())  # some activations clip
    jqw = jq.with_activation_scale(jq.quantize_weight(w, b), a_max)
    tqw = tq.with_activation_scale(tq.quantize_weight(w, b), a_max)
    assert np.float32(tqw.inv_a) == np.asarray(jqw.inv_a)
    assert np.asarray(jqw.out_scale).tobytes() == \
        tqw.out_scale.numpy().tobytes()
    ref = np.asarray(jq.int8_dense_static(jnp.asarray(x), jqw), np.float32)
    got = tqw(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2)
    # the quantized activations are identical, clip included
    jx8 = jnp.clip(jnp.round(jnp.asarray(x) * jqw.inv_a), -127, 127)
    np.testing.assert_array_equal(
        tq.quantize_static_values(torch.from_numpy(x), tqw.inv_a).numpy(),
        np.asarray(jx8, np.int8))


def test_act_scale_matches_jax():
    x = _x(5, 32, 9)
    a_max = float(np.abs(x).max())
    js = jq.with_act_scale(jq.make_act_scale(), a_max)
    ts = tq.with_act_scale(tq.ActScale(), a_max)
    assert np.float32(ts.inv) == np.asarray(js.inv)
    assert np.float32(ts.scale) == np.asarray(js.scale)
    np.testing.assert_array_equal(
        tq.quantize_static(torch.from_numpy(x), ts).numpy(),
        np.asarray(jq.quantize_static(jnp.asarray(x), js)))


def test_quant_weight_records_amax_while_observed():
    w, b = _weights(32, 8, 0)
    qw = tq.quantize_weight(w, b)
    x1, x2 = torch.full((2, 32), 0.5), torch.full((3, 32), -2.0)
    qw(x1)  # not observing: nothing recorded
    qw.start_observing()
    qw(x1)
    qw(x2)
    assert float(qw.stop_observing()) == 2.0
    assert qw.amax is None and not qw.calibrated
