"""Port's fp32 NAR/AR code samplers (tasks/sampling.py, CPU) against the
JAX package's make_nar_sampler / make_ar_sampler on the same flax
parameters and inputs: cluster ids and codes equal, probabilities within
1e-5, the same refusals. Each JAX sampler is compiled once per module."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.xlxmert import XLxmert as JaxXLxmert
from xlxmert_tpu.tasks import sampling as jsam
from xlxmert_tpu.utils.boxes import box_position
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.tasks import sampling as tsam

# tests/test_sampling.py's TINY, on a 3x3 grid
TINY = dict(vocab_size=64, hidden_size=32, num_attention_heads=4,
            intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
            visual_feat_dim=16, num_clusters=20)
GRID = 3
N_CELLS = GRID * GRID


@pytest.fixture(scope="module")
def setup():
    """JAX XLxmert fp32 parameters with every leaf redrawn from a seed
    (biases, LayerNorms and mask_feat off their init values), the port's
    fp32 model on the same tree, centroids and two prompts."""
    rng = np.random.RandomState(0)
    B, L = 2, 6
    ids = rng.randint(1, 64, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[1, 4:] = 0.0
    centroids = rng.randn(20, 16).astype(np.float32)
    jmodel = JaxXLxmert(JaxConfig(**TINY), dtype=jnp.float32)
    params = jax.jit(lambda k: jmodel.init(
        k, ids, jnp.zeros((B, N_CELLS, 16)), jnp.zeros((B, N_CELLS, 4)),
        attention_mask=mask, vis_mask=jnp.ones((B, N_CELLS)),
        centroids=centroids, heads=("obj",))["params"])(
        jax.random.PRNGKey(0))
    params = {k: v for k, v in params.items()
              if k in ("bert", "obj_predict_head", "mask_feat")}

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.randn(*np.shape(leaf)).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * noise
        return (0.3 if "kernel" in name or "embedding" in name
                else 0.5) * noise

    params = jax.tree_util.tree_map_with_path(redraw, params)
    model = tsam.sampler_model(params, LxmertConfig(**TINY),
                               dtype=torch.float32, device="cpu")
    t = (torch.from_numpy(centroids), torch.from_numpy(ids).long(),
         torch.from_numpy(mask))
    return jmodel, params, (centroids, ids, mask), model, t


@pytest.fixture(scope="module")
def jax_samplers(setup):
    jmodel = setup[0]
    return {"nar": jsam.make_nar_sampler(jmodel, 4, GRID),
            "nar collect": jsam.make_nar_sampler(
                jmodel, 3, GRID, collect_intermediate=True),
            "confidence": jsam.make_ar_sampler(jmodel, GRID, "confidence"),
            "TLBR": jsam.make_ar_sampler(jmodel, GRID, "TLBR",
                                         n_steps=N_CELLS + 3),
            "order": jsam.make_ar_sampler(jmodel, GRID, "order")}


def _same(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_nar_sampler_matches_jax(setup, jax_samplers):
    _, params, jin, model, tin = setup
    code, ids, prob = jax_samplers["nar"](params, *jin)
    tcode, tids, tprob = tsam.make_nar_sampler(model, 4, GRID)(*tin)
    _same(tids, ids)
    _same(tcode, code)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), atol=1e-5,
                               rtol=0)
    # every cell committed: the final code rows are their clusters'
    np.testing.assert_array_equal(tcode.numpy(), jin[0][tids.numpy()])


def test_nar_collect_intermediate_matches_jax(setup, jax_samplers):
    _, params, jin, model, tin = setup
    codes, ids, prob = jax_samplers["nar collect"](params, *jin)
    tcodes, tids, tprob = tsam.make_nar_sampler(
        model, 3, GRID, collect_intermediate=True)(*tin)
    assert tuple(tcodes.shape) == (3, 2, N_CELLS, 16)
    assert tuple(tids.shape) == (3, 2, N_CELLS)
    _same(tids, ids)
    _same(tcodes, codes)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("strategy", ["confidence", "TLBR", "order"])
def test_ar_sampler_matches_jax(setup, jax_samplers, strategy):
    _, params, jin, model, tin = setup
    args = ()
    if strategy == "order":
        args = (np.random.RandomState(1).permutation(N_CELLS),)
    code, ids = jax_samplers[strategy](params, *jin, *map(jnp.asarray, args))
    n_steps = N_CELLS + 3 if strategy == "TLBR" else None
    tcode, tids = tsam.make_ar_sampler(model, GRID, strategy,
                                       n_steps=n_steps)(*tin, *args)
    _same(tids, ids)
    _same(tcode, code)
    assert (tcode.abs().sum(-1) > 0).all()


def test_ar_order_wraps_and_refuses_like_jax(setup, jax_samplers):
    _, params, jin, model, tin = setup
    base = np.random.RandomState(1).permutation(N_CELLS)
    sampler = tsam.make_ar_sampler(model, GRID, "order")
    _, ref_ids = sampler(*tin, base)
    _, wrap_ids = sampler(*tin, torch.from_numpy(base + N_CELLS))
    _same(wrap_ids, ref_ids.numpy())
    _, jwrap = jax_samplers["order"](params, *jin,
                                     jnp.asarray(base + N_CELLS))
    _same(wrap_ids, jwrap)
    for fn, args in ((jax_samplers["order"], (params, *jin,
                                              jnp.asarray(base[:4]))),
                     (sampler, (*tin, base[:4]))):
        with pytest.raises(ValueError, match="entries for"):
            fn(*args)
    for make in (jsam.make_ar_sampler, tsam.make_ar_sampler):
        with pytest.raises(ValueError, match="strategy"):
            make(setup[0] if make is jsam.make_ar_sampler else model, GRID,
                 "random")
    with pytest.raises(ValueError, match="positions"):
        sampler(*tin)


def test_ar_tlbr_commits_in_order(setup):
    model, tin = setup[3], setup[4]
    code, _ = tsam.make_ar_sampler(model, GRID, "TLBR", n_steps=3)(*tin)
    assert (code[:, :3].abs().sum(-1) > 0).all()
    assert code[:, 3:].abs().sum() == 0


def test_schedule_and_ranks():
    assert tsam.nar_mask_counts(4, 64) == jsam.nar_mask_counts(4, 64) \
        == [64, 48, 32, 16]
    assert tsam.nar_mask_counts(8, 64) == jsam.nar_mask_counts(8, 64)
    # the integer form the loops use: int(2/3 * 9) is 6 in floating
    # point, and so is (2 * 9) // 3
    assert tsam.nar_mask_counts(3, 9) == [9, 6, 3]
    prob = torch.tensor([[0.3, 0.1, 0.1, 0.5, 0.1]])
    # ties go to the lower index, as jnp.argsort's stable sort
    assert tsam.remask_by_rank(prob, 2).tolist() == [
        [False, True, True, False, False]]
    ranks = np.asarray(jnp.argsort(jnp.argsort(prob.numpy(), axis=-1),
                                   axis=-1))
    assert ((ranks < 2) == tsam.remask_by_rank(prob, 2).numpy()).all()
    pos = tsam.grid_positions(GRID, 2, "cpu")
    np.testing.assert_array_equal(pos[1].numpy(), box_position(GRID))
