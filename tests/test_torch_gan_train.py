"""The GAN's training half in the port (models/gan.py in training mode,
the Discriminator, models/resnet.py, core/optim.Adam and
tasks/train_generator.py) against the JAX package on the same variables,
carried across in the flax layout, at a tiny width, fp32, on the CPU.

Tolerances: forwards, spectral-norm vectors, batch statistics and losses
within 1e-5 of the reference's largest |value| (the same convolutions
summed in another order). After one D-step and one G-step:
  - Adam's moments (mu is the gradient: b1 = 0) within 1e-5 of the
    leaf's largest |value| plus 1e-6 of the tree's: a conv bias that
    feeds an instance norm has a gradient that is zero but for rounding,
    ~1e-7 of the tree's largest on both sides;
  - the new parameters within 1e-5 of the leaf's largest |value| plus
    twice the change of Adam's step that the two gradients' difference
    allows (lr |dg| / (sqrt(nu / (1 - b2^t)) + eps) with b1 = 0): where
    a gradient is zero but for rounding, Adam's step is dominated by
    eps and that rounding, and may differ by up to lr.
The noise scales start at 0, so every forward is noise-free: jax.random
and a torch.Generator cannot draw the same normals. Their gradients
depend on each framework's draw, so they are compared apart: each
moves by lr against the sign of its own gradient (Adam's first step
with b1 = 0).
"""
import copy
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from xlxmert_tpu.core.config import GanConfig as JaxGanConfig
from xlxmert_tpu.models import gan as jgan
from xlxmert_tpu.models import resnet as jres
from xlxmert_tpu.parallel.mesh import make_mesh
from xlxmert_tpu.tasks import train_generator as jtg
from xlxmert_tpu_torch.core.config import GanConfig
from xlxmert_tpu_torch.core.convert import (
    convert_torch_state_dict, split_variables,
)
from xlxmert_tpu_torch.core.optim import Adam
from xlxmert_tpu_torch.models import gan as tgan
from xlxmert_tpu_torch.models import resnet as tres
from xlxmert_tpu_torch.tasks import train_generator as ttg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores")
TOL = 1e-5
# base 8, emb 16, 7 classes, a 4x4 grid at 16 px: two up/down blocks
KW = dict(emb_dim=16, codebook_dim=8, g_base_dim=8, d_base_dim=8, init_H=4,
          init_W=4, target_size=16, n_classes=7, mixed_precision=False,
          batch_size=4)
B = 4


def make_batch(seed, n_classes=7, emb=16, grid=4, size=16, b=B):
    r = np.random.RandomState(seed)
    centroids = r.randn(n_classes, emb).astype(np.float32)
    ids = r.randint(0, n_classes, (b, grid * grid)).astype(np.int32)
    code = centroids[ids].reshape(b, grid, grid, emb)
    image = np.tanh(r.randn(b, size, size, 3)).astype(np.float32)
    return {"image": image, "code": code, "cluster_id": ids}, centroids


def host(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree if hasattr(tree, "shape") else np.asarray(tree)


def shapes(tree):
    return {(p, tuple(np.shape(v))) for p, v in leaves(tree)}


def assert_close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{what}: |d| {err} > {tol} x {scale}"


def resnet_variables(model, seed=0):
    """Random variables of a port ResNet in the flax layout ({"params",
    "batch_stats"}, numpy): He-normal kernels, a normal fc, BN scales
    near 1, biases and running means near 0, variances near 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if len(shape) == 4:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif len(shape) == 2:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif leaf == "weight":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "var":
            v = 0.5 + rng.random(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return split_variables(convert_torch_state_dict(sd))


def jax_state(jeng, tree):
    """The JAX engine's GanState holding a tree in the JAX CLI's layout
    (the port's state_to_tree): restore_state onto the state's
    structure, without running the JAX init."""
    g = {"params": tree["params_g"]}
    d = {"params": tree["params_d"]}
    template = jtg.GanState(
        step=jnp.zeros((), jnp.int32), params_g=g["params"],
        params_d=d["params"], sn_g=tree["sn_g"], sn_d=tree["sn_d"],
        opt_g=jeng.tx_g.init(g["params"]), opt_d=jeng.tx_d.init(d["params"]),
        stats_g=tree["stats_g"], tx_g=jeng.tx_g, tx_d=jeng.tx_d)
    return serialization.from_state_dict(template, tree)


def assert_state_matches(jstate, tstate, g_lr, d_lr):
    """The port's state (state_to_tree) against the JAX GanState after the
    same steps, at the module docstring's bars."""
    ref = host(serialization.to_state_dict(jstate))
    got = ttg.state_to_tree(tstate)
    assert ({k for k, _ in leaves(ref)} == {k for k, _ in leaves(got)})
    assert int(got["step"]) == int(ref["step"])
    for side, lr in (("g", g_lr), ("d", d_lr)):
        opt_r, opt_t = ref[f"opt_{side}"]["0"], got[f"opt_{side}"]["0"]
        assert int(opt_t["count"]) == int(opt_r["count"])
        for m in ("mu", "nu"):
            top = max(np.abs(v).max() for _, v in leaves(opt_r[m]))
            t = dict(leaves(opt_t[m]))
            for path, r in leaves(opt_r[m]):
                if "noise" in path:
                    continue
                err = np.abs(t[path] - r).max()
                assert err <= TOL * np.abs(r).max() + 1e-6 * top, \
                    (side, m, path, err)
        # the parameters follow from the gradients (Adam with b1 = 0:
        # step = lr * g / (sqrt(nu / (1 - b2^t)) + eps), which moves by at
        # most lr * |dg| / (sqrt(nu / (1 - b2^t)) + eps) with g): each
        # element within 1e-5 of its leaf's largest |value| plus twice
        # what its gradient's difference allows
        c2 = 1 - 0.999 ** int(opt_r["count"])
        g_r, g_t = dict(leaves(opt_r["mu"])), dict(leaves(opt_t["mu"]))
        nu_r, nu_t = dict(leaves(opt_r["nu"])), dict(leaves(opt_t["nu"]))
        new = dict(leaves(got[f"params_{side}"]))
        for path, r in leaves(ref[f"params_{side}"]):
            if "noise" in path:
                continue
            root = np.sqrt(np.minimum(nu_r[path], nu_t[path]) / c2) + 1e-7
            allow = (TOL * np.abs(r).max()
                     + 2 * lr * np.abs(g_t[path] - g_r[path]) / root)
            excess = (np.abs(new[path] - r) - allow).max()
            assert excess <= 0, (side, path, excess)
        for path, r in leaves(ref[f"sn_{side}"]):
            assert_close(dict(leaves(got[f"sn_{side}"]))[path], r,
                         f"sn_{side}{path}")
    for path, r in leaves(ref["stats_g"]):
        assert_close(dict(leaves(got["stats_g"]))[path], r, f"stats{path}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_adam_matches_optax():
    r = np.random.RandomState(0)
    params = {"a": r.randn(3, 4).astype(np.float32),
              "b": r.randn(5).astype(np.float32)}
    tx = optax.adam(4e-4, b1=0.0, b2=0.999, eps=1e-7)
    jp, js = params, tx.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Adam(tp, 4e-4, 0.0, 0.999, eps=1e-7)
    for i in range(3):
        g = {k: (r.randn(*v.shape) * 10.0 ** -i).astype(np.float32)
             for k, v in params.items()}
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
    assert opt.count == int(js[0].count) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=1e-6, atol=0)


def test_snconv_power_iteration_matches_jax():
    """One power iteration (u, v written back), sigma and the output,
    against flax's SNConv(update_sn=True); without update_sn the stored
    vectors are used as they are."""
    r = np.random.RandomState(1)
    x = r.randn(2, 6, 6, 8).astype(np.float32)
    jconv = jgan.SNConv(8, 3, use_sn=True, feature_group_count=4)
    variables = host(jax.jit(jconv.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    ref, muts = jax.jit(lambda v, x: jconv.apply(
        v, x, update_sn=True, mutable=["sn"]))(variables, jnp.asarray(x))
    conv = tgan.SNConv(8, 8, 3, use_sn=True, feature_group_count=4)
    tgan.load_variables(torch.nn.ModuleDict({"c": conv}),
                        {"c": variables["params"]}, {"c": variables["sn"]})
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), update_sn=True)
    assert_close(got.detach().permute(0, 2, 3, 1).numpy(), ref, "output")
    for k in ("u", "v"):
        assert_close(getattr(conv, k).numpy(), muts["sn"][k], k)
    w = np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)
    sigma = muts["sn"]["u"] @ (w.reshape(8, -1) @ muts["sn"]["v"])
    assert_close(conv.sigma().detach().numpy(), sigma, "sigma")
    u = conv.u.clone()
    conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(conv.u, u)


@pytest.mark.parametrize("norm", ["spade_in", "spade_bn"])
def test_generator_train_forward_matches_jax(norm):
    """G(train=True, update_sn=True) with the noise scales at 0: the image,
    the spectral norms' new u, v and (spade_bn) the batch statistics,
    from running statistics that are not the init's."""
    kw = dict(emb_dim=16, base_dim=8, target_size=16, init_H=4, init_W=4,
              codebook_dim=8, norm_type=norm)
    batch, _ = make_batch(2)
    code = jnp.asarray(batch["code"])
    G = jgan.Generator(**kw)
    variables = tgan.init_variables(tgan.Generator(**kw), seed=0)
    r = np.random.RandomState(3)
    stats = jax.tree.map(lambda a: (a + r.rand(*a.shape)).astype(np.float32),
                         variables.get("batch_stats", {}))
    variables = dict(variables, batch_stats=stats)
    ref, muts = jax.jit(lambda v, c: G.apply(
        v, c, train=True, update_sn=True, mutable=["sn", "batch_stats"],
        rngs={"noise": jax.random.PRNGKey(2)}))(variables, code)
    gen = tgan.load_variables(tgan.Generator(**kw), variables["params"],
                              variables["sn"], stats or None)
    got = gen(torch.from_numpy(batch["code"]), train=True, update_sn=True,
              noise=torch.Generator().manual_seed(0))
    assert_close(got.detach().numpy(), ref, "image")
    now = tgan.variables_of(gen)
    for col in ("sn", "batch_stats") if stats else ("sn",):
        for path, v in leaves(host(muts[col])):
            assert_close(dict(leaves(now[col]))[path], v, f"{col}{path}")
    with pytest.raises(ValueError, match="noise"):
        gen(torch.from_numpy(batch["code"]), train=True)


@pytest.mark.parametrize("acgan", [True, False])
def test_discriminator_matches_jax(acgan):
    """D(update_sn=True): adv (ACGAN) or adv + projection, every block's
    output (D_layers), the ACGAN logits against the centroid table, and
    the new u, v; random_discriminator_variables has the flax layout."""
    kw = dict(base_dim=8, emb_dim=16, target_size=16, init_H=4, init_W=4,
              acgan=acgan, n_classes=7)
    batch, centroids = make_batch(4)
    img, code = jnp.asarray(batch["image"]), jnp.asarray(batch["code"])
    D = jgan.Discriminator(**kw)
    layout = jax.eval_shape(lambda: D.init(jax.random.PRNGKey(0), img, y=code,
                                           centroids=jnp.asarray(centroids)))
    variables = tgan.random_discriminator_variables(
        8, 16, 16, init_H=4, n_classes=7, acgan=acgan, seed=0)
    for col in ("params", "sn"):
        assert shapes(variables[col]) == shapes(layout[col])
    # a nonzero classifier bias, so that its add is checked too
    if acgan:
        variables["params"]["emb_classifier_bias"] = np.arange(
            7, dtype=np.float32) / 7
    ref, muts = jax.jit(lambda v, x, y, c: D.apply(
        v, x, y=y, centroids=c, update_sn=True, mutable=["sn"]))(
        variables, img, code, jnp.asarray(centroids))
    disc = tgan.load_variables(tgan.Discriminator(**kw),
                               variables["params"], variables["sn"])
    got = disc(torch.from_numpy(batch["image"]),
               y=torch.from_numpy(batch["code"]),
               centroids=torch.from_numpy(centroids), update_sn=True)
    assert len(got) == len(ref) == (3 if acgan else 2)
    assert_close(got[0].detach().numpy(), ref[0], "adv")
    assert len(got[1]) == len(ref[1]) == 3
    for i, (a, b) in enumerate(zip(got[1], ref[1])):
        assert_close(a.detach().numpy(), b, f"D_layers[{i}]")
    if acgan:
        assert got[2].dtype == torch.float32 and got[2].shape == (B * 16, 7)
        assert_close(got[2].detach().numpy(), ref[2], "logits")
    for path, v in leaves(host(muts["sn"])):
        assert_close(dict(leaves(tgan.variables_of(disc)["sn"]))[path], v,
                     f"sn{path}")


def test_losses_match_jax():
    r = np.random.RandomState(5)
    real, fake = r.randn(8).astype(np.float32), r.randn(8).astype(np.float32)
    logits = (3 * r.randn(32, 7)).astype(np.float32)
    ids = r.randint(0, 7, (2, 16)).astype(np.int32)
    t = torch.from_numpy
    for got, ref in (
            (ttg.hinge_d_loss(t(real), t(fake)),
             jtg.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake))),
            (ttg.hinge_g_loss(t(fake)), jtg.hinge_g_loss(jnp.asarray(fake))),
            (ttg.cluster_ce(t(logits), t(ids)),
             jtg.cluster_ce(jnp.asarray(logits), jnp.asarray(ids)))):
        assert_close(got.numpy(), np.asarray(ref), "loss")


# ---------------------------------------------------------------------------
# the engine: one D-step and one G-step against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run():
    """The JAX engine (norm_type spade_bn: batch statistics) from a fresh
    state through one D-step and one G-step, on one device; the port's
    engine on the CPU from the same variables."""
    cfg = dict(KW, norm_type="spade_bn")
    jeng = jtg.GanEngine(JaxGanConfig(**cfg),
                         mesh=make_mesh(devices=jax.devices()[:1]))
    batch, centroids = make_batch(6)
    c = jnp.asarray(centroids)
    eng = ttg.GanEngine(GanConfig(**cfg), device="cpu")
    tstate = eng.create_state(0, centroids)
    jstate = jax_state(jeng, ttg.state_to_tree(tstate))
    start = copy.deepcopy(tstate)
    key = jax.random.PRNGKey(1)
    jstate, jd = jeng.d_step()(jstate, batch, c, key)
    jstate, jg = jeng.g_step()(jstate, batch, c, key)
    tb, tc = eng.place(batch), torch.from_numpy(centroids)
    tstate, td = eng.d_step(tstate, tb, tc)
    tstate, tg = eng.g_step(tstate, tb, tc)
    return dict(eng=eng, batch=batch, centroids=centroids, jstate=jstate,
                tstate=tstate, start=start,
                metrics=({**host(jd), **host(jg)}, {**td, **tg}))


def test_d_and_g_steps_match_the_jax_engine(run):
    ref, got = run["metrics"]
    assert set(ref) == set(got)
    for k in ref:
        assert_close(got[k].numpy(), ref[k], k)
    cfg = run["eng"].cfg
    assert_state_matches(run["jstate"], run["tstate"], cfg.g_lr, cfg.d_lr)


def test_noise_scales_move_by_lr_against_their_own_gradient(run):
    """The noise scales' gradients come from each framework's draw: each
    moved by lr, against the sign of the port's own gradient."""
    tstate, lr = run["tstate"], run["eng"].cfg.g_lr
    n = 0
    for name, p in tstate.G.named_parameters():
        if ".noise" not in name:
            continue
        g = tstate.opt_g.mu[name]
        assert abs(float(g)) > 1e-4
        np.testing.assert_allclose(float(p), -lr * np.sign(float(g)),
                                   rtol=1e-3)
        n += 1
    assert n == 4


def test_chained_gd_step_equals_sequential_pairs(run):
    """chained_gd_step(2) from a state equals two sequential (D, G) pairs
    from a copy of it, the noise on (the scales are no longer 0)."""
    eng = run["eng"]
    tb, tc = eng.place(run["batch"]), torch.from_numpy(run["centroids"])
    a, b = copy.deepcopy(run["tstate"]), copy.deepcopy(run["tstate"])
    a, dl, gl = eng.chained_gd_step(2)(a, tb, tc)
    d_tot, g_tot = [], []
    for _ in range(2):
        b, dm = eng.d_step(b, tb, tc)
        b, gm = eng.g_step(b, tb, tc)
        d_tot.append(float(dm["d_total"]))
        g_tot.append(float(gm["g_total"]))
    assert float(dl) == pytest.approx(np.mean(d_tot), rel=1e-6)
    assert float(gl) == pytest.approx(np.mean(g_tot), rel=1e-6)
    ta, tb_ = ttg.state_to_tree(a), ttg.state_to_tree(b)
    for (p, x), (_, y) in zip(leaves(ta), leaves(tb_)):
        assert np.array_equal(x, y), p
    assert a.step == run["tstate"].step + 2


def test_state_tree_round_trip_and_refusal(run):
    """restore_state(state_to_tree) reproduces a state, and a tree of
    another config is refused."""
    eng, tstate = run["eng"], run["tstate"]
    other = ttg.restore_state(copy.deepcopy(run["start"]),
                              ttg.state_to_tree(tstate))
    for (p, x), (_, y) in zip(leaves(ttg.state_to_tree(other)),
                              leaves(ttg.state_to_tree(tstate))):
        assert np.array_equal(x, y), p
    tree = ttg.state_to_tree(tstate)
    del tree["sn_d"]["adv_out"]
    with pytest.raises(ValueError, match="different config"):
        ttg.restore_state(copy.deepcopy(tstate), tree)
    img = eng.render(tstate, torch.from_numpy(run["batch"]["code"]))
    assert img.shape == (B, 16, 16, 3) and 0 <= img.min() <= img.max() <= 1


# ---------------------------------------------------------------------------
# the perceptual ResNet
# ---------------------------------------------------------------------------

def test_resnet_taps_and_grid_features_match_jax():
    """A one-block-a-stage ResNet on JAX-init variables (random running
    statistics) at 160 px: the layer1..4 taps, pooled and logits,
    grid_features at a 2x2 grid (the 5x5 layer4 map cropped to 4x4 and
    pooled), and the same variables as a torchvision-layout state dict
    (running_mean, downsample.0, ...) through convert_torch_state_dict."""
    r = np.random.RandomState(7)
    x = r.rand(2, 160, 160, 3).astype(np.float32)
    jm = jres.ResNet((1, 1, 1, 1), num_classes=10)
    variables = host(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(x)))
    variables["batch_stats"] = jax.tree.map(
        lambda a: (r.rand(*a.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    ref, ref_grid = jax.jit(lambda v, im: (
        jm.apply(v, jres.normalize_image(im), return_layers=True),
        jres.grid_features(jm, v, im, 2)))(variables, jnp.asarray(x))
    model = tres.load_variables(tres.ResNet((1, 1, 1, 1), num_classes=10),
                                variables)
    with torch.no_grad():
        got = model(tres.normalize_image(torch.from_numpy(x)),
                    return_layers=True)
        for k in ("layer1", "layer2", "layer3", "layer4", "pooled",
                  "logits"):
            assert_close(got[k].numpy(), ref[k], k)
        grid = tres.grid_features(model, torch.from_numpy(x), 2)
        assert grid.shape == (2, 2, 2, 2048)
        assert_close(grid.numpy(), ref_grid, "grid_features")
        sd = {}
        for k, t in model.state_dict().items():
            k = k.replace(".mean", ".running_mean").replace(
                ".var", ".running_var")
            sd[k] = t
            if k.endswith("running_var"):
                sd[k.replace("running_var", "num_batches_tracked")] = \
                    torch.tensor(1)
        tv = tres.load_variables(tres.ResNet((1, 1, 1, 1), num_classes=10),
                                 split_variables(convert_torch_state_dict(sd)))
        small = torch.from_numpy(x[:, :64, :64])
        assert torch.equal(tv(small), model(small))
    full = jax.eval_shape(lambda: jres.resnet50().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert shapes(resnet_variables(tres.resnet50())) == shapes(
        {"params": full["params"], "batch_stats": full["batch_stats"]})


def test_perceptual_term_matches_jax():
    """GanEngine._perceptual (layer1..4 L1 / 4) with a small ResNet in
    place of the ResNet-50 on both sides; 0 without encoder weights."""
    r = np.random.RandomState(8)
    fake = np.tanh(r.randn(2, 32, 32, 3)).astype(np.float32)
    real = np.tanh(r.randn(2, 32, 32, 3)).astype(np.float32)
    model = tres.ResNet((1, 1, 1, 1))
    variables = resnet_variables(model, seed=1)
    jeng = jtg.GanEngine(JaxGanConfig(**KW),
                         mesh=make_mesh(devices=jax.devices()[:1]))
    jeng.E, jeng.E_vars = jres.ResNet((1, 1, 1, 1)), variables
    ref = jax.jit(jeng._perceptual)(jnp.asarray(fake), jnp.asarray(real))
    eng = ttg.GanEngine(GanConfig(**KW), device="cpu")
    eng.E = tres.load_variables(model, variables)
    got = eng._perceptual(torch.from_numpy(fake), torch.from_numpy(real))
    assert_close(got.detach().numpy(), np.asarray(ref), "perceptual")
    assert float(ttg.GanEngine(GanConfig(**KW), device="cpu")._perceptual(
        torch.from_numpy(fake), torch.from_numpy(real))) == 0.0
