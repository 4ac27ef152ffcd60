"""Data parallelism in the port on 2 ranks over gloo on the CPU, one
spawn for every case: fine-tuning steps (VQA with update_freq 1 and 2,
NLVR2; the clip active) against the JAX package's FinetuneEngine on a
2-device data mesh at the global batch and against the port's single
process; a D-step and a G-step of the GAN with the "batch" SPADE norm
against the JAX GanEngine on a 2-device mesh; the multi-process predict
merge against one process's predict; the sharded feature table against
the unsharded one, bit for bit. Bars: those of the single-process
parity tests (tests/test_torch_finetune.py, tests/test_torch_gan_train
.py)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_finetune as tft
import test_torch_gan_train as tgt
import torch_rank_bodies as bodies
from xlxmert_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from xlxmert_tpu.core.config import GanConfig as JaxGanConfig
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.parallel.mesh import make_mesh
from xlxmert_tpu.tasks import train_generator as jtg
from xlxmert_tpu.tasks.finetune import FinetuneEngine as JaxEngine
from xlxmert_tpu_torch.core.config import GanConfig
from xlxmert_tpu_torch.parallel.launch import spawn
from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
from xlxmert_tpu_torch.tasks import train_generator as ttg

SPAWN_TIMEOUT = 150
FT_CASES = (("vqa", 1, 6), ("vqa", 2, 6), ("nlvr2", 1, 4))
GAN_KW = dict(tgt.KW, norm_type="spade_bn")


def _batches(task, n, seed):
    return (tft.nlvr2_batches(n, seed) if task == "nlvr2"
            else tft.vqa_batches(n, seed))


def _n_answers(task):
    return 2 if task == "nlvr2" else tft.NUM_ANSWERS


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    jeng0, _ = tft.engines("vqa", 1)
    params = {"vqa": tft.jax_params(jeng0, 0),
              "nlvr2": tft.jax_params(tft.engines("nlvr2", 1)[0], 1)}
    calls = []
    for task, uf, n in FT_CASES:
        calls.append(("finetune_steps", dict(
            model_kw=tft.CFG_KW, ft_kw=dict(tft.FT_KW, update_freq=uf),
            task=task, n_answers=_n_answers(task), params=params[task],
            batches=_batches(task, n, 0), total_steps=tft.TOTAL_STEPS)))
    # the GAN from the port's fresh state, which the JAX side loads
    gan_batch, centroids = tgt.make_batch(6)
    eng = ttg.GanEngine(GanConfig(**GAN_KW), device="cpu")
    start = ttg.state_to_tree(eng.create_state(0, centroids))
    calls.append(("gan_steps", dict(gan_kw=GAN_KW, tree=start,
                                    batch=gan_batch, centroids=centroids)))
    pred = tft._with_ids(tft.vqa_batches(5, seed=11), "vqa")
    calls.append(("predict_merge", dict(
        model_kw=tft.CFG_KW, ft_kw=tft.FT_KW, task="vqa",
        n_answers=tft.NUM_ANSWERS, params=params["vqa"], batches=pred,
        shard_dir=str(tmp_path_factory.mktemp("shards")))))
    rows = np.random.RandomState(3).randn(7, 2, 2, 8).astype(np.float32)
    idx = np.array([6, 0, 3, 3, 5, 1])
    calls.append(("feature_table", dict(rows=rows, idx=idx)))
    calls.append(("replicated_module", {}))
    ranks = spawn(bodies.cases, 2, (calls,), timeout=SPAWN_TIMEOUT,
                  device="cpu")
    return dict(params=params, ranks=ranks, gan=(gan_batch, centroids, start),
                pred=pred, table=(rows, idx))


@pytest.mark.parametrize("case", range(len(FT_CASES)))
def test_finetune_steps_match_jax_on_a_data_mesh(dp_run, case):
    task, uf, n = FT_CASES[case]
    r0, r1 = (r[case] for r in dp_run["ranks"])
    assert r0["checksum"] == r1["checksum"]       # replicas stay equal
    batches = _batches(task, n, 0)
    jeng_ = JaxEngine(JaxFinetuneConfig(task=task, update_freq=uf,
                                        **tft.FT_KW), _n_answers(task),
                      model_cfg=JaxConfig(**tft.CFG_KW),
                      total_steps=tft.TOTAL_STEPS,
                      mesh=make_mesh((2,), ("data",), jax.devices()[:2]))
    jstate = jeng_.create_state(
        jax.random.PRNGKey(0), params=jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float32), dp_run["params"][task]))
    jstep, rng = jeng_.train_step(), jax.random.PRNGKey(5)
    jl, jn = [], []
    for i, b in enumerate(batches):
        do = tft.should_update(i, n, uf)
        if uf > 1:
            jstate, m = jstep(jstate, jeng_.place(b), rng, jnp.asarray(do))
        else:
            jstate, m = jstep(jstate, jeng_.place(b), rng)
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
    tl = [s["loss"] for s in r0["steps"]]
    assert tl == [s["loss"] for s in r1["steps"]]
    k = 5 if uf > 1 else 2            # the steps before Adam's noise
    np.testing.assert_allclose(tl[:k], jl[:k], rtol=2e-6)
    np.testing.assert_allclose(tl, jl, rtol=5e-2)
    if uf == 1:                       # the global batch's norm
        np.testing.assert_allclose([s["grad_norm"] for s in r0["steps"]],
                                   jn, rtol=1e-4)
        assert max(jn) > tft.FT_KW["clip_grad_norm"]     # the clip bites

    class _S:
        def params(self):
            return r0["params"]

    tft.assert_param_envelope(jstate, _S())


def test_gan_steps_match_jax_on_a_data_mesh(dp_run):
    r0, r1 = (r[len(FT_CASES)] for r in dp_run["ranks"])
    for k, v in r0["stats"].items():              # SyncBN: one statistic
        assert np.array_equal(v, r1["stats"][k]), k
    assert r0["stats"]
    batch, centroids, start = dp_run["gan"]
    jeng = jtg.GanEngine(JaxGanConfig(**GAN_KW),
                         mesh=make_mesh(devices=jax.devices()[:2]))
    jstate = tgt.jax_state(jeng, start)
    c, key = jnp.asarray(centroids), jax.random.PRNGKey(1)
    jstate, jd = jeng.d_step()(jstate, jeng.place(batch), c, key)
    jstate, jg = jeng.g_step()(jstate, jeng.place(batch), c, key)
    ref = {**tgt.host(jd), **tgt.host(jg)}
    got = {**r0["d"], **r0["g"]}
    assert set(ref) == set(got)
    for k in ref:
        tgt.assert_close(got[k], ref[k], k)
    eng = ttg.GanEngine(GanConfig(**GAN_KW), device="cpu")
    tstate = eng.create_state(0, centroids)
    ttg.restore_state(tstate, r0["tree"])
    tgt.assert_state_matches(jstate, tstate, eng.cfg.g_lr, eng.cfg.d_lr)


def test_predict_merge_equals_one_process(dp_run):
    merged = [r[len(FT_CASES) + 1] for r in dp_run["ranks"]]
    assert merged[0] == merged[1]
    _, teng = tft.engines("vqa", 1)
    state = teng.create_state(0, params=dp_run["params"]["vqa"])
    want = teng.predict(state.model, [dict(b) for b in dp_run["pred"]])
    assert merged[0] == want and len(want) == 5 * tft.B - 1


def test_sharded_feature_table_is_bit_equal(dp_run):
    rows, idx = dp_run["table"]
    parts = [r[len(FT_CASES) + 2] for r in dp_run["ranks"]]
    # 7 images over 2 ranks: 4 rows each, the last padded
    assert [p["rows_here"] for p in parts] == [4, 4]

    class Reader:
        def get(self, i):
            return rows[int(i)]

    cache = FeatureCache.build(Reader(), [str(i) for i in range(7)],
                               device="cpu")
    want = FeatureCache.lookup(cache.table, torch.from_numpy(idx)).float()
    for p in parts:
        assert np.array_equal(p["feats"], want.numpy())


def test_replicate_broadcasts_the_first_ranks_weights(dp_run):
    for r in dp_run["ranks"]:
        for v in r[len(FT_CASES) + 3].values():
            assert (v == 1.0).all()
