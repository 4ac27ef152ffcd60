"""Tensor parallelism in the port (parallel/sharding.py through
tasks/pretrain.py) on 2 ranks over gloo on the CPU, tp = 2: a
pre-training step of word_mask and of vis_mask against the JAX
package's TP step on a (4, 2) ("data", "model") mesh and against the
port's single-process step, at the JAX tests' bars (loss rtol 2e-5,
every updated parameter, gathered, atol 2e-5:
tests/test_tensor_parallel.py); with dropout 0.1 and on-device masks,
a few steps leave the replicated parameters bit-equal across the model
group and equal to the single process's. The spec rules against the
JAX package's on every parameter of the model."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from test_torch_pretrain import (
    CENTROIDS, CFG_KW, LR, TOTAL_STEPS, flat, make_batch, train_kw,
)
import torch_rank_bodies as bodies
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.core.config import TrainConfig as JaxTrainConfig
from xlxmert_tpu.parallel.mesh import replicated
from xlxmert_tpu.parallel.sharding import lxmert_param_spec as jax_spec
from xlxmert_tpu.parallel.sharding import shard_params as jax_shard
from xlxmert_tpu.tasks import pretrain as jpre
from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
from xlxmert_tpu_torch.core.convert import flax_path
from xlxmert_tpu_torch.parallel.launch import spawn
from xlxmert_tpu_torch.parallel.sharding import lxmert_param_spec
from xlxmert_tpu_torch.tasks import pretrain as tpre

SPAWN_TIMEOUT = 120
TP_TASKS = ("word_mask", "vis_mask")


def _jax_params():
    jeng = jpre.PretrainEngine(JaxTrainConfig(**train_kw()),
                               model_cfg=JaxConfig(**CFG_KW),
                               total_steps=TOTAL_STEPS)
    return jax.tree.map(np.asarray, jeng.init_params(jax.random.PRNGKey(0)))


def _single(params, batches, tasks, model_kw=CFG_KW, tkw=None):
    eng = tpre.PretrainEngine(TrainConfig(**(tkw or train_kw())),
                              model_cfg=LxmertConfig(**model_kw),
                              total_steps=TOTAL_STEPS, device="cpu")
    state = eng.create_state(0, params)
    cent = torch.from_numpy(CENTROIDS)
    losses = [float(eng.train_step(state, b, t, cent)["total_loss"])
              for b, t in zip(batches, tasks)]
    return losses, state


@pytest.fixture(scope="module")
def tp_run():
    params = _jax_params()
    batches = [make_batch(3), make_batch(4)]
    drop_kw = dict(CFG_KW, hidden_dropout_prob=0.1,
                   attention_probs_dropout_prob=0.1)
    # on-device masks: the batches without the host masks
    drop_batches = [{k: v for k, v in make_batch(s).items()
                     if k in ("word_id", "other_word_id", "matched_label",
                              "cluster_id")} for s in (5, 6, 7)]
    drop_tasks = ("vis_mask", "word_mask", "matched")
    common = dict(centroids=CENTROIDS, mesh_shape=(1, 2),
                  axis_names=("data", "model"), params=params,
                  total_steps=TOTAL_STEPS)
    calls = [("pretrain_steps", dict(common, model_kw=CFG_KW,
                                     train_kw=train_kw(), batches=batches,
                                     tasks=TP_TASKS)),
             ("pretrain_steps", dict(common, model_kw=drop_kw,
                                     train_kw=train_kw(),
                                     batches=drop_batches,
                                     tasks=drop_tasks))]
    ranks = spawn(bodies.cases, 2, (calls,), timeout=SPAWN_TIMEOUT,
                  device="cpu")
    return {"params": params, "batches": batches, "ranks": ranks,
            "drop": (drop_kw, drop_batches, drop_tasks)}


def _jax_tp_steps(params, batches):
    cfg = JaxTrainConfig(**train_kw(), mesh_shape=(4, 2),
                         mesh_axis_names=("data", "model"))
    jeng = jpre.PretrainEngine(cfg, model_cfg=JaxConfig(**CFG_KW),
                               total_steps=TOTAL_STEPS)
    state = jpre.TrainState.create(
        jax_shard(jax.tree.map(jnp.asarray, params), jeng.mesh), jeng.tx)
    state = state.replace(step=jax.device_put(state.step,
                                              replicated(jeng.mesh)))
    losses = []
    for b, task in zip(batches, TP_TASKS):
        state, m = jeng.train_step(task)(state, jeng.place(b),
                                         jax.random.PRNGKey(42),
                                         jnp.asarray(CENTROIDS))
        losses.append(float(m["total_loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


def test_tp_steps_match_jax_tp_and_the_single_process(tp_run):
    r0, r1 = tp_run["ranks"][0][0], tp_run["ranks"][1][0]
    got = [s["metrics"]["total_loss"] for s in r0["steps"]]
    assert got == [s["metrics"]["total_loss"] for s in r1["steps"]]
    jl, jparams = _jax_tp_steps(tp_run["params"], tp_run["batches"])
    sl, sstate = _single(tp_run["params"], tp_run["batches"], TP_TASKS)
    np.testing.assert_allclose(got, jl, rtol=2e-5)
    np.testing.assert_allclose(got, sl, rtol=2e-5)
    mine, want_j, want_s = (flat(r0["params"]), flat(jparams),
                            flat(sstate.params()))
    assert mine.keys() == want_j.keys() == want_s.keys()
    for k in mine:
        np.testing.assert_allclose(mine[k], want_j[k], atol=2e-5,
                                   err_msg=k)
        np.testing.assert_allclose(mine[k], want_s[k], atol=2e-5,
                                   err_msg=k)
    # the gradient all-reduces of the model group ran (f and g)
    assert all(s["comm"]["calls"] > 0 for s in r0["steps"])


def test_dropout_steps_keep_replicas_bit_equal(tp_run):
    """dropout 0.1 and masks drawn on the device: the model group draws
    one stream, so its replicated parameters stay bit-equal, and the
    step equals the single process's (the sharded heads keep their part
    of the single process's mask)."""
    r0, r1 = tp_run["ranks"][0][1], tp_run["ranks"][1][1]
    assert r0["replicated"].keys() == r1["replicated"].keys()
    assert len(r0["replicated"]) > 20
    for k, v in r0["replicated"].items():
        assert np.array_equal(v, r1["replicated"][k]), k
    drop_kw, batches, tasks = tp_run["drop"]
    sl, sstate = _single(tp_run["params"], batches, tasks, drop_kw)
    np.testing.assert_allclose(
        [s["metrics"]["total_loss"] for s in r0["steps"]], sl, rtol=2e-5)
    want = flat(sstate.params())
    for k, v in flat(r0["params"]).items():
        np.testing.assert_allclose(v, want[k], atol=2e-5, err_msg=k)


def test_spec_rules_match_the_jax_markers():
    """Every parameter of the pre-training model: the port's split
    dimension against the JAX PartitionSpec of its flax path (kernels
    are transposed: a column-parallel (in, out) kernel splits the torch
    weight's rows)."""
    eng = tpre.PretrainEngine(TrainConfig(**train_kw()),
                              model_cfg=LxmertConfig(**CFG_KW),
                              device="cpu")

    class K:
        def __init__(self, key):
            self.key = key

    n_split = 0
    for name, p in eng.build_model().named_parameters():
        path, _ = flax_path(name, p.dim())
        spec = jax_spec([K(x) for x in path], np.zeros(p.shape))
        want = {P(None, "model"): 0, P("model", None): 1,
                P("model"): 0, P(): None}[spec]
        assert lxmert_param_spec(name, p.dim()) == want, name
        n_split += want is not None
    assert n_split >= 16
