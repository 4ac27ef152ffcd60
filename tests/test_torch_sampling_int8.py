"""Port's int8 samplers (serving/sampling_int8.py, CPU, plain kernel
versions) against the JAX package's serving/sampling_int8.py: the
sampler tree's int8 weights byte for byte, the calibrated maxima per
site, the cluster logits of a step, and the decode loops' commit and
re-mask mechanics against a numpy restatement."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.xlxmert import XLxmert as JaxXLxmert
from xlxmert_tpu.ops.quant import ActScale as JaxActScale
from xlxmert_tpu.ops.quant import QuantWeight as JaxQuantWeight
from xlxmert_tpu.serving import lxmert_int8 as jeng
from xlxmert_tpu.serving import sampling_int8 as jsi
from xlxmert_tpu.utils.boxes import box_position
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.serving import lxmert_int8 as teng
from xlxmert_tpu_torch.serving import sampling_int8 as tsi

# tests/test_sampling_int8.py's CFG and grid
SHAPE = dict(vocab_size=89, hidden_size=32, num_attention_heads=4,
             intermediate_size=64, l_layers=2, x_layers=1, r_layers=1,
             visual_feat_dim=16, num_clusters=23)
JCFG, TCFG = JaxConfig(**SHAPE), LxmertConfig(**SHAPE)
GRID = 3
N_CELLS = GRID * GRID
B, L = 3, 6


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)


def jax_sites(tree, prefix):
    """{id-key: dotted path} for every calibration site of a JAX tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, JaxQuantWeight):
            out[id(node.w_i8)] = path
        elif isinstance(node, JaxActScale):
            out[id(node.key)] = path
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")

    walk(tree, prefix)
    return out


@pytest.fixture(scope="module")
def setup():
    """The flax tree (tests/test_sampling_int8.py's setup), both sampler
    trees, each calibrated: the JAX one as the port's kernel runs it
    (the packed-head attention, no excess precision)."""
    rng = np.random.RandomState(0)
    ids = rng.randint(1, SHAPE["vocab_size"], (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[2, 4:] = 0.0
    centroids = (rng.randn(SHAPE["num_clusters"], SHAPE["visual_feat_dim"])
                 .astype(np.float32) * 0.5)
    code = centroids[rng.randint(0, SHAPE["num_clusters"], (B, N_CELLS))]
    pos = np.broadcast_to(box_position(GRID)[None], (B, N_CELLS, 4))
    model = JaxXLxmert(JCFG, dtype=jnp.float32)
    params = jax.jit(lambda k: model.init(
        k, ids, code, pos, attention_mask=mask, centroids=centroids,
        heads=("obj",))["params"])(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, dict(params))
    params["mask_feat"] = rng.randn(16).astype(np.float32) * 0.3
    params["obj_predict_head"]["out_cluster_bias"] = (
        rng.randn(SHAPE["num_clusters"]).astype(np.float32) * 0.1)

    jsp = jsi.prepare_sampler_params(params, JCFG, centroids)
    jit = jax.jit
    try:
        jax.jit = functools.partial(
            jit, compiler_options={"xla_allow_excess_precision": False})
        jeng.attention_impl("pallas_blhd")
        jcal = jsi.calibrate_sampler(jsp, jnp.asarray(centroids), ids,
                                     mask, JCFG, grid_size=GRID)
    finally:
        jax.jit = jit
        jeng.attention_impl("auto")
    tsp = tsi.prepare_sampler_params(params, TCFG, centroids, "cpu")
    tin = (torch.from_numpy(centroids), torch.from_numpy(ids).long(),
           torch.from_numpy(mask))
    tcal = tsi.calibrate_sampler(tsp, tin[0], tin[1], tin[2], TCFG, GRID)
    teng.apply_calibration(tsp)
    teng.assert_fully_calibrated(tsp)
    return dict(params=params, centroids=centroids, ids=ids, mask=mask,
                code=code, pos=pos, jsp=jsp, jcal=jcal, tsp=tsp, tcal=tcal,
                tin=tin)


def test_sampler_tree_quantizes_like_jax(setup):
    jsp, tsp = setup["jsp"], setup["tsp"]
    paths = jax_sites(jsp, "0")
    mods = dict(teng.calibration_sites(tsp))
    assert set(paths.values()) == set(mods)
    n = 0
    for leaf in jax.tree.leaves(
            jsp, is_leaf=lambda x: isinstance(x, JaxQuantWeight)):
        if isinstance(leaf, JaxQuantWeight):
            got = mods[paths[id(leaf.w_i8)]]
            assert np.array_equal(got.w_i8.numpy().T, np.asarray(leaf.w_i8))
            assert np.array_equal(got.scale.numpy(), np.asarray(leaf.scale))
            assert np.array_equal(got.bias.numpy(), np.asarray(leaf.bias))
            n += 1
    # the engine's sites plus transform, linear_feat and the tied cluster
    # weight, whose int8 bytes are the centroid table's
    assert n == 4 * 2 + 4 * 1 + 11 * 1 + 1 + 3
    c = mods["0.obj_head.cluster"]
    assert tuple(c.w_i8.shape) == (SHAPE["num_clusters"], 16)
    assert np.array_equal(c.w_i8.numpy().T,
                          np.asarray(jsp["obj_head"]["cluster"].w_i8))
    assert tsp.mask_feat.dtype == torch.bfloat16
    np.testing.assert_array_equal(tsp.mask_feat.float().numpy(),
                                  np.asarray(jsp["mask_feat"], np.float32))


def test_calibration_amax_matches_jax_per_site(setup):
    paths = jax_sites(setup["jsp"], "0")
    jcal, tcal = setup["jcal"], setup["tcal"]
    assert len(jcal) == len(paths) == len(tcal)
    for key, amax in jcal.items():
        np.testing.assert_allclose(tcal[paths[key]], amax, rtol=1e-2,
                                   err_msg=paths[key])


def test_predict_forward_logits_match_jax(setup):
    """A step's cluster logits through the calibrated engines on a
    half-masked grid, held out of calibration."""
    rng = np.random.RandomState(1)
    vm = rng.rand(B, N_CELLS) < 0.5
    feats = np.where(vm[..., None], setup["params"]["mask_feat"],
                     setup["code"]).astype(np.float32)
    ssp = jeng.apply_calibration(setup["jsp"], setup["jcal"])
    try:
        jeng.attention_impl("pallas_blhd")
        ref = np.asarray(jax.jit(lambda sp, *a: jsi._predict_forward(
            sp, *a, SHAPE["num_attention_heads"]))(
            ssp, setup["ids"], jnp.asarray(feats, jnp.bfloat16),
            jnp.asarray(setup["pos"], jnp.bfloat16), setup["mask"]))
    finally:
        jeng.attention_impl("auto")
    tin = setup["tin"]
    with torch.inference_mode():
        got = tsi._predict_forward(
            setup["tsp"], tin[1], torch.from_numpy(feats).to(torch.bfloat16),
            torch.from_numpy(setup["pos"].copy()).to(torch.bfloat16),
            tin[2], SHAPE["num_attention_heads"]).numpy()
    assert got.shape == ref.shape == (B, N_CELLS, SHAPE["num_clusters"])
    assert cos(got, ref) > 0.99
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


class Recorder:
    """An on_step hook keeping each step's inputs and logits."""

    def __init__(self):
        self.steps = []

    def __call__(self, i, inputs, logits):
        self.steps.append((i, {k: v.clone() for k, v in inputs.items()},
                           logits.clone()))


def _first_argmax(x):
    return np.argmax(x, axis=-1)


def _max_prob(logits):
    """The loops' per-cell probability of the argmax, fp32."""
    return torch.exp(logits.amax(-1) - torch.logsumexp(logits, -1)).numpy()


def test_nar_loop_mechanics_match_a_numpy_restatement(setup):
    """Re-mask the n_mask lowest cells (stable ranks), substitute
    mask_feat there, commit the argmax's centroid at the masked cells:
    from the step logits the loop saw, exactly."""
    n_steps = 3
    rec = Recorder()
    sampler = tsi.make_nar_sampler_int8(TCFG, n_steps, GRID, on_step=rec)
    code, ids, prob = sampler(setup["tsp"], *setup["tin"])
    table = torch.from_numpy(setup["centroids"]).to(torch.bfloat16)
    mask_feat = setup["tsp"].mask_feat.float().numpy()
    c = np.zeros((B, N_CELLS, 16), np.float32)
    i_ = np.zeros((B, N_CELLS), np.int64)
    p = np.zeros((B, N_CELLS), np.float32)
    assert [s[0] for s in rec.steps] == list(range(n_steps))
    for i, inputs, logits in rec.steps:
        n_mask = ((n_steps - i) * N_CELLS) // n_steps
        vm = np.zeros((B, N_CELLS), bool)
        for b in range(B):
            vm[b, np.argsort(p[b], kind="stable")[:n_mask]] = True
        np.testing.assert_array_equal(inputs["vis_mask"].numpy(), vm)
        np.testing.assert_array_equal(
            inputs["feats"].float().numpy(),
            np.where(vm[..., None], mask_feat, c))
        lg = logits.numpy()
        pred = _first_argmax(lg)
        p = _max_prob(logits)
        c = np.where(vm[..., None], table[torch.from_numpy(pred)]
                     .float().numpy(), c)
        i_ = np.where(vm, pred, i_)
    np.testing.assert_array_equal(ids.numpy(), i_)
    np.testing.assert_array_equal(code.float().numpy(), c)
    np.testing.assert_allclose(prob.numpy(), p, rtol=1e-6)
    assert code.dtype == torch.bfloat16 and prob.dtype == torch.float32


@pytest.mark.parametrize("strategy", ["confidence", "TLBR", "order"])
def test_ar_loop_mechanics_match_a_numpy_restatement(setup, strategy):
    """One cell a step: the most probable unvisited cell (confidence) or
    the given one (TLBR, order; re-masked before the step), committed
    once; every cell exactly once over grid_size**2 steps."""
    rec = Recorder()
    order = np.random.RandomState(5).permutation(N_CELLS) + N_CELLS
    args = (order,) if strategy == "order" else ()
    sampler = tsi.make_ar_sampler_int8(TCFG, GRID, strategy, on_step=rec)
    code, ids = sampler(setup["tsp"], *setup["tin"], *args)
    table = setup["centroids"].astype(np.float32)
    table = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    mask_feat = setup["tsp"].mask_feat.float().numpy()
    c = np.zeros((B, N_CELLS, 16), np.float32)
    i_ = np.zeros((B, N_CELLS), np.int64)
    vm = np.ones((B, N_CELLS), bool)
    visited = np.zeros((B, N_CELLS), bool)
    for i, inputs, logits in rec.steps:
        cur = {"TLBR": i % N_CELLS, "order": order[i] % N_CELLS}.get(
            strategy)
        if cur is not None:
            vm[:, cur] = True
        np.testing.assert_array_equal(inputs["vis_mask"].numpy(), vm)
        np.testing.assert_array_equal(
            inputs["feats"].float().numpy(),
            np.where(vm[..., None], mask_feat, c))
        pred = _first_argmax(logits.numpy())
        if cur is None:
            cur_b = _first_argmax(np.where(visited, -10000.0,
                                           _max_prob(logits)))
        else:
            cur_b = np.full(B, cur)
        upd = np.zeros((B, N_CELLS), bool)
        upd[np.arange(B), cur_b] = True
        assert not (upd & visited).any()
        c = np.where(upd[..., None], table[pred], c)
        i_ = np.where(upd, pred, i_)
        vm &= ~upd
        visited |= upd
    assert visited.all() and len(rec.steps) == N_CELLS
    np.testing.assert_array_equal(ids.numpy(), i_)
    np.testing.assert_array_equal(code.float().numpy(), c)


@pytest.mark.parametrize("strategy", ["TLBR", "order"])
def test_selective_head_is_bit_identical(setup, strategy):
    """selective_head runs the cluster head on the current cell only:
    each row is quantized alone and the int8 products are exact, so the
    commits equal the full head's bit for bit."""
    args = ((np.random.RandomState(7).permutation(N_CELLS),)
            if strategy == "order" else ())
    full = tsi.make_ar_sampler_int8(TCFG, GRID, strategy)
    sel = tsi.make_ar_sampler_int8(TCFG, GRID, strategy,
                                   selective_head=True)
    code_f, ids_f = full(setup["tsp"], *setup["tin"], *args)
    code_s, ids_s = sel(setup["tsp"], *setup["tin"], *args)
    assert torch.equal(ids_f, ids_s)
    assert torch.equal(code_f, code_s)


def test_refusals():
    with pytest.raises(ValueError, match="strategy"):
        tsi.make_ar_sampler_int8(TCFG, GRID, "random")
    with pytest.raises(ValueError, match="strategy"):
        jsi.make_ar_sampler_int8(JCFG, GRID, "random")
