"""Port's fused FFN (plain version, CPU) against the JAX package's
`ops.ffn.fused_ffn` (Pallas, interpret mode on the CPU) and
`reference_ffn`, on the same numpy-seeded inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from xlxmert_tpu.ops.ffn import fused_ffn as jax_fused_ffn
from xlxmert_tpu.ops.ffn import reference_ffn
from xlxmert_tpu_torch.ops.ffn import fused_ffn, fused_ffn_reference


def make(M=32, H=64, I=256, seed=0):
    """The inputs of tests/test_fused_ffn.py, in the JAX layout: w1
    (H, I), w2 (I, H)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, H).astype(np.float32) * 0.5
    w1 = rng.randn(H, I).astype(np.float32) * 0.05
    b1 = rng.randn(I).astype(np.float32) * 0.05
    w2 = rng.randn(I, H).astype(np.float32) * 0.05
    b2 = rng.randn(H).astype(np.float32) * 0.05
    g = rng.rand(H).astype(np.float32) + 0.5
    be = rng.randn(H).astype(np.float32) * 0.1
    return x, w1, b1, w2, b2, g, be


def port(x, w1, b1, w2, b2, g, be, dtype=torch.float32, **kw):
    """The port's call: nn.Linear layout, w1 (I, H) and w2 (H, I)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return fused_ffn(t(x).to(dtype), t(w1.T).to(dtype), t(b1),
                     t(w2.T).to(dtype), t(b2), t(g), t(be), **kw)


@pytest.mark.parametrize("approx", [True, False])
def test_fused_ffn_fp32_matches_jax_kernel_and_reference(approx):
    """fp32: the tolerance of tests/test_fused_ffn.py (sums in another
    order)."""
    args = make()
    got = port(*args, approx_gelu=approx).numpy()
    jargs = [jnp.asarray(a) for a in args]
    for ref in (jax_fused_ffn(*jargs, approx_gelu=approx, chunk=128),
                reference_ffn(*jargs, approx_gelu=approx)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5,
                                   rtol=1e-4)


def test_fused_ffn_bf16_matches_jax_kernel():
    """bf16 x and weights: both sides round h and the output to bf16 at
    the same points; fp32 sums in another order can move a value across
    a rounding boundary, by one bf16 step (2^-7 of the largest output at
    most), at the output or at an h element. 99 % of the outputs must be
    equal."""
    args = make(seed=2)
    got = port(*args, dtype=torch.bfloat16).float().numpy()
    jargs = [jnp.asarray(a) for a in args]
    for i in (0, 1, 3):   # x, w1, w2 in bf16; b, g, beta stay fp32
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    ref = np.asarray(jax_fused_ffn(*jargs, chunk=128), np.float32)
    np.testing.assert_allclose(got, ref, atol=2.0 ** -7 * np.abs(ref).max())
    assert (got == ref).mean() >= 0.99


def test_fused_ffn_leading_dims_and_odd_rows():
    """24 rows as (2, 12, H): the wrapper folds leading dims into rows."""
    x, w1, b1, w2, b2, g, be = make(M=24, H=64, I=128, seed=1)
    got = port(x.reshape(2, 12, 64), w1, b1, w2, b2, g, be)
    ref = reference_ffn(jnp.asarray(x.reshape(2, 12, 64)), w1, b1, w2, b2,
                        g, be)
    assert got.shape == (2, 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


def test_fused_ffn_wrapper_takes_the_plain_version_only_on_the_cpu():
    from xlxmert_tpu_torch.ops import ffn

    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in make(M=4)]
    args[1], args[3] = args[1].t(), args[3].t()
    before = ffn.KERNEL.launches
    torch.testing.assert_close(fused_ffn(*args),
                               fused_ffn_reference(*args), atol=0, rtol=0)
    assert ffn.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ffn(*(a.to("meta") for a in args))
