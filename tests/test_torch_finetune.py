"""Port's fine-tuning engine (tasks/finetune.py, CPU, fp32, dropout 0)
against the JAX package's `FinetuneEngine` on the same converted weights
and batches: VQA with update_freq=2 and NLVR2 trajectories, predict in
both modes, the int8 `nlvr2_forward`, the evaluators and QA surgery."""
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.data import answer_table as jat
from xlxmert_tpu.data import evaluators as jev
from xlxmert_tpu.serving import lxmert_int8 as jeng
from xlxmert_tpu.tasks.finetune import FinetuneEngine as JaxEngine
from xlxmert_tpu_torch.core.config import FinetuneConfig, LxmertConfig
from xlxmert_tpu_torch.data import answer_table as tat
from xlxmert_tpu_torch.data import evaluators as tev
from xlxmert_tpu_torch.serving import lxmert_int8 as teng
from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine, should_update

# the trajectory test's shapes (tests/test_finetune_trajectory_parity.py)
B, L, G = 8, 8, 3
V = G * G
FEAT_DIM = 24
NUM_ANSWERS = 13
LR = 2e-3
TOTAL_STEPS = 12
CFG_KW = dict(vocab_size=111, hidden_size=48, num_attention_heads=4,
              intermediate_size=96, l_layers=2, x_layers=1, r_layers=1,
              visual_feat_dim=FEAT_DIM, visual_pos_dim=4,
              num_qa_labels=NUM_ANSWERS, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
FT_KW = dict(batch_size=B, max_text_length=L, grid_size=G,
             mixed_precision=False, lr=LR, warmup_ratio=0.25,
             weight_decay=0.01, clip_grad_norm=1.0, adam_eps=1e-6)


def engines(task, update_freq):
    n = 2 if task == "nlvr2" else NUM_ANSWERS
    j = JaxEngine(JaxFinetuneConfig(task=task, update_freq=update_freq,
                                    **FT_KW), n,
                  model_cfg=JaxConfig(**CFG_KW), total_steps=TOTAL_STEPS)
    t = FinetuneEngine(FinetuneConfig(task=task, update_freq=update_freq,
                                      **FT_KW), n,
                       model_cfg=LxmertConfig(**CFG_KW),
                       total_steps=TOTAL_STEPS, device="cpu")
    return j, t


def jax_params(eng, seed):
    """The JAX engine's init, every leaf redrawn so biases and LayerNorm
    parameters are not zeros and ones (numpy)."""
    tree = jax.device_get(eng.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * noise
        return (0.05 if "kernel" in name or "embedding" in name
                else 0.02) * noise

    return jax.tree_util.tree_map_with_path(redraw, tree)


def vqa_batches(n, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = r.randint(1, CFG_KW["vocab_size"], (B, L)).astype(np.int32)
        ids[:, 0] = 1
        ids[0, L - 2:] = 0
        soft = r.rand(B, NUM_ANSWERS).astype(np.float32)
        out.append({"word_ids": ids,
                    "vis_feats": r.randn(B, V, FEAT_DIM).astype(np.float32)
                    * 0.5,
                    "boxes": r.rand(B, V, 4).astype(np.float32),
                    "targets": soft / soft.sum(1, keepdims=True)})
    return out


def nlvr2_batches(n, seed=1):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = r.randint(1, CFG_KW["vocab_size"], (B, L)).astype(np.int32)
        ids[:, 0] = 1
        ids[2, L - 3:] = 0
        out.append({"word_ids": ids,
                    "vis_feats": r.randn(B, 2, V, FEAT_DIM).astype(
                        np.float32) * 0.5,
                    "boxes": r.rand(B, 2, V, 4).astype(np.float32),
                    "labels": r.randint(0, 2, (B,)).astype(np.int32)})
    return out


def assert_param_envelope(jstate, tstate):
    final = jax.device_get(jstate.params)
    ours = tstate.params()
    jl = jax.tree_util.tree_leaves_with_path(final)
    tl = jax.tree_util.tree_leaves_with_path(ours)
    assert len(jl) == len(tl)
    for (pj, a), (pt, b) in zip(jl, tl):
        assert jax.tree_util.keystr(pj) == jax.tree_util.keystr(pt)
        np.testing.assert_allclose(b, np.asarray(a), atol=6 * LR, rtol=0.05,
                                   err_msg=jax.tree_util.keystr(pj))


def run_both(task, update_freq, batches, seed):
    jeng_, teng_ = engines(task, update_freq)
    params = jax_params(jeng_, seed)
    jstate = jeng_.create_state(
        jax.random.PRNGKey(0),
        params=jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params))
    jstep = jeng_.train_step()
    tstate = teng_.create_state(seed, params=params)
    rng = jax.random.PRNGKey(5)
    jl, tl, jn, tn = [], [], [], []
    for i, b in enumerate(batches):
        do = should_update(i, len(batches), update_freq)
        if update_freq > 1:
            jstate, m = jstep(jstate, jeng_.place(b), rng, jnp.asarray(do))
        else:
            jstate, m = jstep(jstate, jeng_.place(b), rng)
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
        tm = teng_.train_step(tstate, b, do)
        tl.append(float(tm["loss"]))
        tn.append(float(tm["grad_norm"]))
    return jstate, tstate, np.array(jl), np.array(tl), jn, tn


def test_vqa_trajectory_update_freq2_matches_jax():
    """6 batches, update_freq=2: updates at steps 2 (covering three
    batches), 4 and 5 (the flush). Losses through step 4 precede any
    effective update (the first has lr 0): forward parity at 2e-6; then
    the param envelope of the JAX trajectory test, and every count 3."""
    jstate, tstate, jl, tl, jn, tn = run_both("vqa", 2, vqa_batches(6), 0)
    np.testing.assert_allclose(tl[:5], jl[:5], rtol=2e-6)
    np.testing.assert_allclose(tl, jl, rtol=3e-2)
    np.testing.assert_allclose(tn[:5], jn[:5], rtol=1e-4)
    assert abs(tl[0] - tl[-1]) > 1e-5
    assert_param_envelope(jstate, tstate)
    assert set(tstate.opt.count.values()) == {3}
    assert {int(c) for c in jax.tree.leaves(
        jax.device_get(jstate.opt_state.count))} == {3}
    assert tstate.opt.sched_step == 3 and tstate.step == 6
    assert all(float(a.abs().max()) == 0 for a in tstate.acc.values())


def test_nlvr2_trajectory_matches_jax():
    """4 plain steps: the 2-image flatten, the repeated sentence, CE."""
    jstate, tstate, jl, tl, jn, tn = run_both("nlvr2", 1, nlvr2_batches(4),
                                              1)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=2e-6)
    np.testing.assert_allclose(tl, jl, rtol=5e-2)
    np.testing.assert_allclose(tn[:2], jn[:2], rtol=1e-4)
    assert_param_envelope(jstate, tstate)
    assert set(tstate.opt.count.values()) == {4}


def _with_ids(batches, task):
    out = []
    for s, b in enumerate(batches):
        b = dict(b)
        b["question_ids"] = [f"q{s}_{i}" for i in range(B)]
        b["n_valid"] = B - 1 if s == len(batches) - 1 else B
        out.append(b)
    return out


@pytest.mark.parametrize("task", ["vqa", "nlvr2"])
def test_predict_both_modes_agree_with_jax(task):
    """Eval forward and --serve_int8 (calibrated on the first 2 batches,
    then serving the rest): every valid question answered, with the JAX
    engine's answers on ≥ 0.8 of them (tests/test_finetune.py's bar for
    int8 against fp32 at near-tie random weights)."""
    jeng_, teng_ = engines(task, 1)
    params = jax_params(jeng_, 2)
    tstate = teng_.create_state(0, params=params)
    make = nlvr2_batches if task == "nlvr2" else vqa_batches
    batches = _with_ids(make(3, seed=11), task)
    label2ans = None if task == "nlvr2" else [f"a{i}" for i in
                                              range(NUM_ANSWERS)]
    jp = jax.tree.map(jnp.asarray, params)
    for int8 in (False, True):
        ref = jeng_.predict(jp, [dict(b) for b in batches], label2ans,
                            int8=int8, calib_batches=2)
        got = teng_.predict(tstate.model, [dict(b) for b in batches],
                            label2ans, int8=int8, calib_batches=2)
        assert set(got) == set(ref) and len(got) == 3 * B - 1
        agree = np.mean([got[k] == ref[k] for k in ref])
        assert agree >= (0.95 if not int8 else 0.8), (int8, agree)
    assert tstate.model.training  # predict restores the mode


@pytest.fixture(scope="module")
def nlvr2_calibrated():
    shape = dict(vocab_size=200, hidden_size=64, num_attention_heads=4,
                 intermediate_size=128, l_layers=2, x_layers=2, r_layers=1,
                 visual_feat_dim=32, num_clusters=0)
    jcfg, tcfg = JaxConfig(**shape), LxmertConfig(**shape)
    bert, head = teng.random_params(tcfg, 5, seed=3)
    head["logit_fc_0"]["kernel"] = np.random.RandomState(4).randn(
        128, 128).astype(np.float32) * 0.02     # the 2*hidden input
    head["logit_fc_3"] = {"kernel": np.random.RandomState(5).randn(
        128, 2).astype(np.float32) * 0.02, "bias": np.zeros(2, np.float32)}

    def batch(seed, n=4):
        r = np.random.RandomState(seed)
        ids = r.randint(1, 200, (n, 10)).astype(np.int32)
        mask = np.ones((n, 10), np.float32)
        mask[1, 7:] = 0
        ids[1, 7:] = 0
        feats = (r.randn(n, 2, 16, 32) * 0.5).astype(np.float32)
        pos = r.rand(n, 2, 16, 4).astype(np.float32)
        return ids, feats, pos, mask

    jqp, jhp = jeng.prepare_params(bert, jcfg), jeng.prepare_answer_head(head)

    def jfwd(qp, hp, ids, feats, pos, mask):
        return jeng.nlvr2_forward(qp, hp, ids, feats, pos,
                                  attention_mask=mask, n_heads=4)

    batches = [batch(s) for s in (1, 2)]
    jit = jax.jit
    try:
        # the reference's declared bf16 numerics, as tests/
        # test_torch_serving.py calibrates it
        jax.jit = functools.partial(
            jit, compiler_options={"xla_allow_excess_precision": False})
        jeng.attention_impl("pallas_blhd")
        jcal = jeng.calibrate_forward(jfwd, (jqp, jhp), batches)
    finally:
        jax.jit = jit
        jeng.attention_impl("auto")
    sqp, shp = (jeng.apply_calibration(t, jcal) for t in (jqp, jhp))
    tqp = teng.prepare_params(bert, tcfg, device="cpu")
    thp = teng.prepare_answer_head(head, device="cpu")
    teng.calibrate(tqp, thp, [tuple(torch.from_numpy(a) for a in b)
                              for b in batches], tcfg,
                   forward=teng.nlvr2_forward)
    teng.apply_calibration(tqp, thp)
    teng.assert_fully_calibrated(tqp, thp)
    return sqp, shp, tqp, thp, batch


def test_nlvr2_forward_matches_jax_engine(nlvr2_calibrated):
    """The int8 NLVR2 forward (sentence encoded once per example, cross
    layers on both images) against the JAX engine's, each calibrated on
    the same two batches, on a held-out batch: the bar of the port's
    VQA engine test (cosine > 0.99)."""
    sqp, shp, tqp, thp, batch = nlvr2_calibrated
    ids, feats, pos, mask = batch(9, n=8)
    try:
        jeng.attention_impl("pallas_blhd")
        ref = np.asarray(jax.jit(lambda a, b, *x: jeng.nlvr2_forward(
            a, b, *x[:3], attention_mask=x[3], n_heads=4))(
            sqp, shp, ids, feats, pos, mask))
    finally:
        jeng.attention_impl("auto")
    with torch.inference_mode():
        got = teng.nlvr2_forward(tqp, thp, *(torch.from_numpy(a) for a in
                                             (ids, feats, pos)),
                                 attention_mask=torch.from_numpy(mask),
                                 n_heads=4).numpy()
    assert got.shape == ref.shape == (8, 2)
    a, b = got.ravel().astype(np.float64), ref.ravel().astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


def test_evaluators_and_dumps_match_jax(tmp_path):
    id2datum = {1: {"label": {"cat": 1.0, "dog": 0.3}},
                "7": {"label": {"dog": 0.6}}, 3: {"label": {}}}
    preds = {1: "dog", "7": "dog", 3: "cat"}
    for name in ("VQAEvaluator", "GQAEvaluator"):
        j, t = getattr(jev, name)(id2datum), getattr(tev, name)(id2datum)
        assert t.evaluate(preds) == j.evaluate(preds)
        assert t.oracle_score(preds) == j.oracle_score(preds)
        j.dump_result(preds, str(tmp_path / "j.json"))
        t.dump_result(preds, str(tmp_path / "t.json"))
        assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
            (tmp_path / "j.json").read_text())
    nl = {"u1": {"label": 1, "identifier": "a-1"},
          "u2": {"label": 0, "identifier": "a-2"}}
    npreds = {"u1": 1, "u2": 1}
    j, t = jev.NLVR2Evaluator(nl), tev.NLVR2Evaluator(nl)
    assert t.evaluate(npreds) == j.evaluate(npreds) == 0.5
    assert t.confusion(npreds) == j.confusion(npreds)
    j.dump_result(npreds, str(tmp_path / "j.csv"))
    t.dump_result(npreds, str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv"
                                                ).read_text()


def test_qa_surgery_and_load_pretrained_match_jax():
    all_ans = [{"ans": a, "dsets": ["vqa"]} for a in
               ("cat", "dog", "gray", "2", "man")]
    rng = np.random.RandomState(0)
    pre = {"bert": {"pooler": {"dense": {
        "kernel": rng.randn(48, 48).astype(np.float32),
        "bias": rng.randn(48).astype(np.float32)}}},
        "answer_head": {"logit_fc_3": {
            "kernel": rng.randn(96, 5).astype(np.float32),
            "bias": rng.randn(5).astype(np.float32)}}}
    label2ans = ["dog", "grey", "pizza", "the cat", "two", "A man."]
    for name in ("cat", "The Man.", "an apple", "grey", ""):
        assert tat.convert_ans(name) == jat.convert_ans(name)
    jeng_, teng_ = engines("vqa", 1)
    teng_.num_answers = jeng_.num_answers = len(label2ans)
    fresh = teng_.init_params(0)
    fresh["answer_head"]["logit_fc_3"] = {
        "kernel": np.ones((96, 6), np.float32),
        "bias": np.ones(6, np.float32)}
    jm, jc = jeng_.load_pretrained(fresh, pre, label2ans,
                                   jat.AnswerTable(all_ans))
    tm, tc = teng_.load_pretrained(fresh, pre, label2ans,
                                   tat.AnswerTable(all_ans))
    assert tc == jc == (5, 1)
    for (pj, a), (pt, b) in zip(jax.tree_util.tree_leaves_with_path(jm),
                                jax.tree_util.tree_leaves_with_path(tm)):
        assert jax.tree_util.keystr(pj) == jax.tree_util.keystr(pt)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tm["bert"]["pooler"]["dense"]["kernel"],
                                  pre["bert"]["pooler"]["dense"]["kernel"])
