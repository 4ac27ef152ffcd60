"""Port's SPADE generator (models/gan.py, inference, CPU, fp32) against the
JAX package's flax Generator on the same variables: the exact render and
the capped-modulation render (render_mode), the batch-norm SPADE, the
spectral norm's sigma and the bilinear resize."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.convert import convert_torch_state_dict
from xlxmert_tpu.models import gan as jgan
from xlxmert_tpu_torch.core.convert import split_variables
from xlxmert_tpu_torch.models import gan as tgan

# a 64-pixel generator: three upscaling blocks (16, 32, 64), so a cap of
# 32 leaves the last block's SPADEs capped
KW = dict(emb_dim=16, base_dim=8, target_size=64, init_H=8, init_W=8,
          codebook_dim=8)


def keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= keys(v, f"{prefix}{k}/")
        else:
            out.add((prefix + k, np.shape(v)))
    return out


@pytest.fixture(scope="module")
def variables():
    return tgan.random_variables(KW["emb_dim"], KW["base_dim"],
                                 KW["target_size"], KW["init_H"],
                                 KW["codebook_dim"], seed=3)


@pytest.fixture(scope="module")
def emb():
    return np.random.RandomState(0).randn(2, 64, 16).astype(np.float32)


def test_random_variables_have_the_flax_layout(variables, emb):
    init = jax.eval_shape(lambda e: jgan.Generator(**KW).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        e, train=False), jnp.asarray(emb))
    for col in ("params", "sn"):
        assert keys(variables[col]) == keys(dict(init[col]))
    # every stored u, v gives about the kernel's top singular value
    gen = tgan.load_variables(tgan.Generator(**KW), variables["params"],
                              variables["sn"])
    n_sn = 0
    for m in gen.modules():
        if isinstance(m, tgan.SNConv) and m.use_sn:
            w = m.weight.detach().reshape(m.weight.shape[0], -1).double()
            top = float(torch.linalg.matrix_norm(w, ord=2))
            assert abs(float(m.sigma().detach()) - top) < 1e-2 * top
            n_sn += 1
    assert n_sn == 2 + 3 * 3


@pytest.mark.parametrize("cap", [None, 32])
def test_generator_matches_jax(variables, emb, cap):
    try:
        jgan.render_mode(cap)
        ref = np.asarray(jax.jit(lambda v, e: jgan.Generator(**KW).apply(
            v, e, train=False))(variables, jnp.asarray(emb)))
    finally:
        jgan.render_mode(None)
    gen = tgan.load_variables(tgan.Generator(**KW, mod_cap=cap),
                              variables["params"], variables["sn"]).eval()
    with torch.no_grad():
        got = gen(torch.from_numpy(emb)).numpy()
        grid = gen(torch.from_numpy(emb).reshape(2, 8, 8, 16)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(grid, got)
    assert np.abs(got).max() <= 1.0


def test_batch_norm_spade_matches_jax(variables, emb):
    """norm_type spade_bn at inference: the running statistics."""
    rng = np.random.RandomState(4)
    init = jax.eval_shape(lambda e: jgan.Generator(
        **KW, norm_type="spade_bn").init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        e, train=False), jnp.asarray(emb))
    stats = jax.tree.map(lambda x: (rng.rand(*x.shape) + 0.5).astype(
        np.float32), dict(init["batch_stats"]))
    v = dict(variables, batch_stats=stats)
    ref = np.asarray(jax.jit(lambda v, e: jgan.Generator(
        **KW, norm_type="spade_bn").apply(v, e, train=False))(
        v, jnp.asarray(emb)))
    gen = tgan.load_variables(tgan.Generator(**KW, norm_type="spade_bn"),
                              v["params"], v["sn"], stats).eval()
    with torch.no_grad():
        got = gen(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_snconv_sigma_and_grouped_conv_match_jax():
    """A spectral-normed grouped 3x3 conv from a torch-layout state dict
    (weight_orig, weight_u, weight_v), converted and split into flax
    collections as a converted generator checkpoint is: sigma within
    1e-6 relative, the output within 1e-5."""
    rng = np.random.RandomState(2)
    w = rng.randn(8, 2, 3, 3).astype(np.float32)
    u = rng.randn(8).astype(np.float32)
    v = rng.randn(18).astype(np.float32)
    sd = {"conv.weight_orig": torch.from_numpy(w),
          "conv.bias": torch.from_numpy(rng.randn(8).astype(np.float32)),
          "conv.weight_u": torch.from_numpy(u),
          "conv.weight_v": torch.from_numpy(v)}
    cols = split_variables(convert_torch_state_dict(sd))
    assert set(cols) == {"params", "sn"}
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    jconv = jgan.SNConv(8, 3, use_sn=True, feature_group_count=4)
    ref = np.asarray(jconv.apply({"params": cols["params"]["conv"],
                                  "sn": cols["sn"]["conv"]}, jnp.asarray(x)))
    conv = tgan.SNConv(8, 8, 3, use_sn=True, feature_group_count=4)
    tgan.load_variables(torch.nn.ModuleDict({"conv": conv}),
                        cols["params"], cols["sn"])
    sigma = float(u @ (w.reshape(8, -1) @ v))
    assert abs(float(conv.sigma().detach()) - sigma) <= 1e-6 * abs(sigma)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((8, 8), (64, 64)),
                                     ((5, 7), (12, 21)), ((4, 4), (4, 4))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(1).randn(2, *src, 3).astype(np.float32)
    ref = np.asarray(jgan.resize_bilinear(jnp.asarray(x), dst))
    got = tgan.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-6, rtol=0)
    assert np.array_equal(tgan._interp_matrix(*dst[:1], src[0]),
                          jgan._interp_matrix(dst[0], src[0]))
    with pytest.raises(ValueError, match="downsamples"):
        tgan.resize_bilinear(torch.zeros(1, 1, 8, 8), (4, 4))


def test_render_is_the_clis_range(variables, emb):
    gen = tgan.load_variables(tgan.Generator(**KW), variables["params"],
                              variables["sn"]).eval()
    img = tgan.render(gen, torch.from_numpy(emb))
    with torch.no_grad():
        raw = gen(torch.from_numpy(emb))
    assert torch.equal(img, torch.clamp((raw + 1) / 2, 0, 1))
    assert img.min() >= 0 and img.max() <= 1
