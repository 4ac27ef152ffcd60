"""Port's int8 serving engine (CPU, plain kernel versions) against the JAX
package's serving/lxmert_int8.py on the same flax parameters."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.lxmert import LxmertModel, VisualAnswerHead
from xlxmert_tpu.ops.quant import ActScale as JaxActScale
from xlxmert_tpu.ops.quant import QuantWeight as JaxQuantWeight
from xlxmert_tpu.serving import lxmert_int8 as jeng
from xlxmert_tpu.serving.feature_cache import FeatureCache as JaxCache
from xlxmert_tpu.utils.boxes import box_position
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops.quant import QuantWeight
from xlxmert_tpu_torch.serving import lxmert_int8 as teng
from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

# the CFG of tests/test_int8_serving.py
SHAPE = dict(vocab_size=200, hidden_size=64, num_attention_heads=4,
             intermediate_size=128, l_layers=2, x_layers=2, r_layers=2,
             visual_feat_dim=32, num_clusters=0)
JCFG, TCFG = JaxConfig(**SHAPE), LxmertConfig(**SHAPE)
N_ANS, L, V = 29, 12, 16


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)


def batch(seed, B):
    r = np.random.RandomState(seed)
    ids = r.randint(1, 200, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[1, 9:] = 0
    feats = (r.randn(B, V, 32) * 0.5).astype(np.float32)
    pos = np.broadcast_to(box_position(4)[None], (B, V, 4)).copy()
    return ids, feats, pos, mask


def to_torch(b):
    return tuple(torch.from_numpy(a) for a in b)


@pytest.fixture(scope="module")
def params():
    ids, feats, pos, mask = batch(0, 2)
    model = LxmertModel(JCFG, dtype=jnp.float32)
    head = VisualAnswerHead(JCFG, num_labels=N_ANS, dtype=jnp.float32)
    p = jax.jit(lambda k: model.init(k, ids, feats, pos,
                                     attention_mask=mask))(
        jax.random.PRNGKey(0))["params"]
    hp = jax.jit(head.init)(jax.random.PRNGKey(1),
                            jnp.zeros((2, SHAPE["hidden_size"])))["params"]
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, hp)


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


def test_prepare_params_quantizes_like_jax(params):
    p, hp = params
    jqp, jhp = jeng.prepare_params(p, JCFG), jeng.prepare_answer_head(hp)
    tqp = teng.prepare_params(p, TCFG, device="cpu")
    thp = teng.prepare_answer_head(hp, device="cpu")
    mods = dict(teng.calibration_sites(tqp, thp))
    paths = {**jax_sites(jqp, "0"), **jax_sites(jhp, "1")}
    assert set(paths.values()) == set(mods)
    n_dense = 0
    for tree in (jqp, jhp):
        for leaf in jax.tree.leaves(
                tree, is_leaf=lambda x: isinstance(x, JaxQuantWeight)):
            if isinstance(leaf, JaxQuantWeight):
                got = mods[paths[id(leaf.w_i8)]]
                assert isinstance(got, QuantWeight)
                assert np.array_equal(got.w_i8.numpy().T,
                                      np.asarray(leaf.w_i8))
                assert np.array_equal(got.scale.numpy(),
                                      np.asarray(leaf.scale))
                n_dense += 1
    # 4 per language/visual layer, 11 per cross layer, visn_fc, 2 head
    assert n_dense == 4 * 2 + 4 * 2 + 11 * 2 + 1 + 2


def test_random_params_have_the_flax_layout(params):
    p, hp = params
    tp, thp = teng.random_params(TCFG, N_ANS, seed=0)

    def shapes(tree):
        return {jax.tree_util.keystr(k): np.shape(v) for k, v in
                jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(tp) == shapes(p)
    assert shapes(thp) == shapes(hp)


def test_dynamic_forward_matches_jax(params):
    p, _ = params
    ids, feats, pos, mask = batch(1, 4)
    ref = jax.jit(lambda qp, *a: jeng.lxmert_forward(
        qp, *a[:3], attention_mask=a[3], n_heads=4))(
        jeng.prepare_params(p, JCFG), ids, feats, pos, mask)
    tqp = teng.prepare_params(p, TCFG, device="cpu")
    ti, tf, tp, tm = to_torch((ids, feats, pos, mask))
    with torch.inference_mode():
        got = teng.lxmert_forward(tqp, ti, tf, tp, attention_mask=tm,
                                  n_heads=4)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == r.shape
        assert cos(g.float().numpy(), np.asarray(r, np.float32)) > 0.999


@pytest.fixture(scope="module")
def calibrated(params):
    p, hp = params
    jqp, jhp = jeng.prepare_params(p, JCFG), jeng.prepare_answer_head(hp)
    tqp = teng.prepare_params(p, TCFG, device="cpu")
    thp = teng.prepare_answer_head(hp, device="cpu")
    batches = [batch(s, 8) for s in (10, 20)]
    # The reference calibrates with the engine's accelerator attention
    # (the kernel the port runs), compiled without XLA's excess precision:
    # by default XLA:CPU keeps bf16 intermediates in fp32 inside a fusion,
    # so a gelu site records an amax no bf16 value has, and the quantized
    # activations drift by a few bf16 steps from the declared numerics.
    jit = jax.jit
    try:
        jax.jit = functools.partial(
            jit, compiler_options={"xla_allow_excess_precision": False})
        jeng.attention_impl("pallas_blhd")
        jcal = jeng.calibrate(jqp, jhp, batches, JCFG)
    finally:
        jax.jit = jit
        jeng.attention_impl("auto")
    with pytest.raises(RuntimeError, match="static scales"):
        teng.assert_fully_calibrated(tqp, thp)
    tcal = teng.calibrate(tqp, thp, [to_torch(b) for b in batches], TCFG)
    teng.apply_calibration(tqp, thp)
    teng.assert_fully_calibrated(tqp, thp)
    return p, hp, jqp, jhp, jcal, tqp, thp, tcal


def test_calibration_amax_matches_jax_per_site(calibrated):
    _, _, jqp, jhp, jcal, _, _, tcal = calibrated
    paths = {**jax_sites(jqp, "0"), **jax_sites(jhp, "1")}
    assert len(jcal) == len(paths) == len(tcal)
    for key, amax in jcal.items():
        np.testing.assert_allclose(tcal[paths[key]], amax, rtol=1e-2,
                                   err_msg=paths[key])


def test_static_logits_match_jax_pallas_engine(calibrated):
    _, _, jqp, jhp, jcal, tqp, thp, _ = calibrated
    sqp = jeng.apply_calibration(jqp, jcal)
    shqp = jeng.apply_calibration(jhp, jcal)
    ids, feats, pos, mask = batch(99, 32)  # held out of calibration
    try:
        jeng.attention_impl("pallas_blhd")
        ref = np.asarray(jeng.make_vqa_serving_fn(JCFG)(
            sqp, shqp, ids, feats, pos, mask))
    finally:
        jeng.attention_impl("auto")
    ti, tf, tp, tm = to_torch((ids, feats, pos, mask))
    with torch.inference_mode():
        _, _, pooled = teng.lxmert_forward(tqp, ti, tf, tp,
                                           attention_mask=tm, n_heads=4)
        got = teng.answer_head_forward(thp, pooled).numpy()
    assert got.shape == ref.shape == (32, N_ANS)
    assert cos(got, ref) > 0.99
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


def test_feature_cache_lookup_is_exact():
    class Reader:
        def __init__(self, n):
            r = np.random.RandomState(7)
            self.data = {f"img_{i}": r.randn(4, 4, 32).astype(np.float32)
                         for i in range(n)}

        def get(self, img_id):
            return self.data[img_id]

    reader = Reader(5)
    ids = list(reader.data)
    cache = FeatureCache.build(reader, ids, device="cpu")
    jcache = JaxCache.build(reader, ids, dtype=jnp.bfloat16)
    assert cache.table.shape == (5, 16, 32)
    assert cache.table.dtype == torch.bfloat16
    assert cache.nbytes == 5 * 16 * 32 * 2
    picks = [ids[i] for i in (4, 0, 0, 3)]
    idx = cache.indices(picks)
    np.testing.assert_array_equal(idx, jcache.indices(picks))
    got = FeatureCache.lookup(cache.table, torch.from_numpy(idx))
    ref = np.asarray(JaxCache.lookup(jcache.table, jnp.asarray(idx)),
                     np.float32)
    np.testing.assert_array_equal(got.float().numpy(), ref)
