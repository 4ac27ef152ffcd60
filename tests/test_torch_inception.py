"""The port's InceptionV3 (`xlxmert_tpu_torch.models.inception`) against
the JAX package's on the CPU, on the same variables in the JAX layout
with drawn BN statistics and the same seeded inputs: each Inception block
alone at a small spatial size, the whole model at 299x299 (pool3 and the
fc head) in both pooling variants, `preprocess_for_fid`, and a
torchvision-layout state dict with AuxLogits loaded on both sides.

Tolerance (fp32, both sides summing in their own order): max |d| <=
2e-5 of the reference's largest |value| (measured: ~4e-7)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fid import share_the_cores_and_blas  # noqa: F401
from xlxmert_tpu.models import inception as jinc
from xlxmert_tpu_torch.models import inception as tinc

REL = 2e-5
pytestmark = pytest.mark.usefixtures("share_the_cores_and_blas")


def close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    bar = rel * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= bar, (
        float(np.abs(got - ref).max()), bar)


def drawn(shapes, seed):
    """Variables of the given shape tree, drawn as random_variables draws
    (He-normal kernels, BN statistics and affine about the identity)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2 / fan)).astype(
                np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.75, 1.25, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


BLOCKS = {
    # name: (JAX module, port module, input channels)
    "A": (lambda fv: jinc.InceptionA(16, fv),
          lambda fv: tinc.InceptionA(24, 16, fv), 24),
    "B": (lambda fv: jinc.InceptionB(),
          lambda fv: tinc.InceptionB(24), 24),
    "C": (lambda fv: jinc.InceptionC(12, fv),
          lambda fv: tinc.InceptionC(24, 12, fv), 24),
    "D": (lambda fv: jinc.InceptionD(),
          lambda fv: tinc.InceptionD(24), 24),
    "E avg": (lambda fv: jinc.InceptionE("avg", fv),
              lambda fv: tinc.InceptionE(24, "avg", fv), 24),
    "E max": (lambda fv: jinc.InceptionE("max", fv),
              lambda fv: tinc.InceptionE(24, "max", fv), 24),
}


@pytest.mark.parametrize("fid_variant", [True, False])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_each_block_matches_jax(block, fid_variant):
    make_j, make_t, cin = BLOCKS[block]
    jm = make_j(fid_variant)
    # 9x9: the 3x3 pools' padded border is a third of the map
    x = np.random.RandomState(3).randn(2, 9, 9, cin).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables = drawn(shapes, seed=len(block) + 10 * fid_variant)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    tm = tinc.load_variables(make_t(fid_variant), variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got.numpy(), ref)


@pytest.fixture(scope="module")
def whole():
    """The random variables (drawn BN statistics, a 1,008-class fc), two
    inputs at 299x299 in [-1, 1], and for each pooling variant the JAX
    model's pool3 and logits in one jitted function (compiled once for
    the module)."""
    variables = tinc.random_variables(5)
    x = np.random.RandomState(0).rand(2, 299, 299, 3).astype(
        np.float32) * 2 - 1

    def both(fv):
        model = jinc.InceptionV3(fid_variant=fv)
        return jax.jit(lambda v, x: (model.apply(v, x), model.apply(
            v, x, return_logits=True)))

    return variables, x, {fv: both(fv) for fv in (True, False)}


def test_variables_have_the_jax_modules_tree(whole):
    variables, x, _ = whole
    shapes = jax.eval_shape(
        lambda k: jinc.InceptionV3().init(k, x[:1], return_logits=True),
        jax.random.PRNGKey(0))
    assert jax.tree.map(lambda s: s.shape, shapes) == jax.tree.map(
        np.shape, variables)


@pytest.mark.parametrize("fid_variant", [True, False])
def test_whole_model_pool3_and_logits_match_jax(whole, fid_variant):
    variables, x, fns = whole
    model = tinc.inception_from_variables(variables, fid_variant)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        logits = model(torch.from_numpy(x), return_logits=True).numpy()
    ref, ref_logits = fns[fid_variant](variables, x)
    assert got.shape == (2, 2048) and logits.shape == (2, 1008)
    close(got, ref)
    close(logits, ref_logits)


def test_fid_variant_changes_pool3(whole):
    """The two pooling variants differ by more than the tolerance, so the
    per-variant parity above tells them apart."""
    variables, x, _ = whole
    out = {}
    for fv in (True, False):
        with torch.no_grad():
            out[fv] = tinc.inception_from_variables(variables, fv)(
                torch.from_numpy(x)).numpy()
    diff = np.abs(out[True] - out[False]).max()
    assert diff > 100 * REL * np.abs(out[True]).max()


def test_torchvision_state_dict_with_aux_logits(whole):
    """A torchvision-layout state dict (running statistics, step counters,
    AuxLogits) loads into the port as it is and gives the JAX pool3 after
    convert_inception_state_dict."""
    variables, x, fns = whole
    sd = {}
    for k, v in tinc.inception_from_variables(
            variables).state_dict().items():
        k = k.replace(".mean", ".running_mean").replace(".var",
                                                        ".running_var")
        sd[k] = v.clone()
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    sd["AuxLogits.conv0.conv.weight"] = torch.ones(128, 768, 1, 1)
    sd["AuxLogits.fc.weight"] = torch.ones(1008, 768)
    model = tinc.InceptionV3()
    model.load_state_dict(tinc.torchvision_state_dict(sd))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    jvars = jinc.convert_inception_state_dict(sd)
    close(got, fns[True](jvars, x)[0])


@pytest.mark.parametrize("shape", [(64, 64), (123, 457), (299, 299)])
def test_preprocess_for_fid_matches_jax(shape):
    """F.interpolate(bilinear, antialias=False) against jax.image.resize
    (antialias=False): < 1e-4, as the JAX CLI notes; at 299 both only
    rescale."""
    img = np.random.RandomState(1).rand(2, *shape, 3).astype(np.float32)
    got = tinc.preprocess_for_fid(torch.from_numpy(img)).numpy()
    ref = np.asarray(jinc.preprocess_for_fid(jnp.asarray(img)))
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
