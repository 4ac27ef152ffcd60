"""Pre-training in the port (models/xlxmert.py, tasks/pretrain.py,
core/optim's per-task skip, the epoch checkpoint) against the JAX
package on the same parameters, carried across by core/convert, and the
same host-masked batches.

Tolerances: fp32 outputs within 2e-5 absolute (the same products summed
in another order); losses to 1e-5 relative; gradients by cosine >
0.99999; the 6-step trajectory's losses to 1e-3 relative and the final
parameters within 6 * lr absolute (Adam's first updates are about lr
times the sign of the gradient, so fp32 noise of ~1e-6 in a gradient
near 0 can flip one update: the bar of
tests/test_trainer_trajectory_parity.py).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.checkpoint import load_pytree as jax_load_pytree
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.core.config import TrainConfig as JaxTrainConfig
from xlxmert_tpu.parallel.mesh import make_mesh, replicate
from xlxmert_tpu.tasks import pretrain as jpre
from xlxmert_tpu.utils.boxes import box_position
from xlxmert_tpu_torch.core.checkpoint import epoch_ckpt_name, save_pytree
from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
from xlxmert_tpu_torch.core.convert import convert_torch_state_dict
from xlxmert_tpu_torch.models import xlxmert as txl
from xlxmert_tpu_torch.tasks import pretrain as tpre

B, L, G = 8, 8, 3
V = G * G
N_CLUSTERS, FEAT = 50, 24
LR, TOTAL_STEPS = 2e-3, 20
TASKS = ("vis_mask", "word_mask", "matched")
CFG_KW = dict(vocab_size=111, hidden_size=48, num_attention_heads=4,
              intermediate_size=96, l_layers=2, x_layers=2, r_layers=2,
              visual_feat_dim=FEAT, num_qa_labels=17,
              num_clusters=N_CLUSTERS, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)


def train_kw(task_qa=False):
    return dict(batch_size=B, max_text_length=L, grid_size=G,
                feat_dim=FEAT, num_clusters=N_CLUSTERS, clustering=True,
                mixed_precision=False, lr=LR, warmup_ratio=0.05,
                weight_decay=0.01, clip_grad_norm=1.0, adam_eps=1e-6,
                task_qa=task_qa)


def make_batch(seed, task_qa=False):
    """A host-masked batch: both packages read the same masks."""
    r = np.random.RandomState(seed)
    word = r.randint(1, 111, (B, L)).astype(np.int32)
    word[0, L - 2:] = 0
    masked = word.copy()
    label = np.full((B, L), -1, np.int32)
    pos = (r.rand(B, L) < 0.15) & (word > 0)
    pos[:, 1] = True
    label[pos], masked[pos] = word[pos], 103
    vis_mask = (r.rand(B, V) < 0.3).astype(np.float32)
    vis_mask[:, 0] = 1
    batch = {"word_id": word, "masked_word_id": masked, "word_label": label,
             "other_word_id": r.randint(1, 111, (B, L)).astype(np.int32),
             "matched_label": r.randint(0, 2, B).astype(np.int32),
             "cluster_id": r.randint(0, N_CLUSTERS, (B, V)).astype(np.int32),
             "vis_mask": vis_mask}
    if task_qa:
        qa = r.randint(0, 17, B).astype(np.int32)
        qa[0] = -1
        batch["qa_label"] = qa
    return batch


CENTROIDS = (np.random.RandomState(11).randn(N_CLUSTERS, FEAT)
             .astype(np.float32) * 0.5)


def engines(task_qa=False):
    # one device: the port trains in one process on one device
    jeng = jpre.PretrainEngine(JaxTrainConfig(**train_kw(task_qa)),
                               model_cfg=JaxConfig(**CFG_KW),
                               total_steps=TOTAL_STEPS,
                               mesh=make_mesh((1,), ("data",),
                                              jax.devices()[:1]))
    params = jax.tree.map(np.asarray, jeng.init_params(
        jax.random.PRNGKey(0)))
    teng = tpre.PretrainEngine(TrainConfig(**train_kw(task_qa)),
                               model_cfg=LxmertConfig(**CFG_KW),
                               total_steps=TOTAL_STEPS, device="cpu")
    return jeng, teng, params


@pytest.fixture(scope="module")
def setup():
    return engines()


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_model_carries_the_jax_parameter_tree(setup):
    jeng, teng, params = setup
    state = teng.create_state(0, params)
    got, want = flat(state.params()), flat(params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # the port's own init has the same tree and the flax initializers'
    assert flat(teng.init_params(0)).keys() == want.keys()


def test_head_outputs_match_jax_at_fp32(setup):
    jeng, teng, params = setup
    b = make_batch(1)
    pos = np.broadcast_to(box_position(G)[None], (B, V, 4)).astype(
        np.float32)
    feats = CENTROIDS[b["cluster_id"]]
    heads = ("lm", "matched", "obj", "feat")
    mask = (b["word_id"] > 0).astype(np.float32)
    ref = jax.jit(lambda p, *a: jeng.model.apply(
        {"params": p}, *a[:3], attention_mask=a[3], vis_mask=a[4],
        centroids=a[5], word_embedding_matrix=p["bert"]["embeddings"][
            "word_embeddings"]["embedding"], heads=heads,
        deterministic=True))(params, b["word_id"], feats, pos, mask,
                             b["vis_mask"], CENTROIDS)
    # a model holding every head: the feat head shares the obj head
    model = txl.XLxmert(LxmertConfig(**CFG_KW), heads=heads)
    model.load_state_dict(teng.create_state(0, params).model.state_dict())
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(b["word_id"]).long(),
                    torch.from_numpy(feats), torch.from_numpy(pos),
                    attention_mask=torch.from_numpy(mask),
                    vis_mask=torch.from_numpy(b["vis_mask"]),
                    centroids=torch.from_numpy(CENTROIDS),
                    word_embedding_matrix=txl.get_word_embedding_matrix(
                        model), heads=heads)
    for key in ("lm_logits", "matched_logits", "obj_logits", "feat_pred",
                "pooled_output"):
        assert out[key].dtype == torch.float32, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-5, rtol=0, err_msg=key)


def jax_loss_and_grads(jeng, params, batch, task):
    fn = jeng.loss_fn(task)

    @jax.jit
    def run(p, b):
        return jax.value_and_grad(
            lambda q: fn(q, b, jax.random.PRNGKey(0),
                         jnp.asarray(CENTROIDS), True), has_aux=True)(p)

    (total, metrics), grads = run(jax.tree.map(jnp.asarray, params),
                                  jeng.place(batch))
    return float(total), jax.device_get(metrics), jax.device_get(grads)


@pytest.mark.parametrize("task_qa", [False, True])
def test_losses_grads_and_none_gradients_match_jax(task_qa):
    """Per task: the set of parameters without a gradient against JAX's
    used_param_mask; without QA also the losses (host-masked) and the
    gradients against jax.grad (QA adds one head's CE, which the CLI
    test and the loss code share)."""
    jeng, teng, params = engines(task_qa)
    state = teng.create_state(0, params)
    batch = make_batch(2, task_qa)
    cent = torch.from_numpy(CENTROIDS)
    for task in TASKS:
        losses, grads = teng.loss_and_grads(state.model, teng.place(batch),
                                            task, cent, state.generator)
        # the None set against JAX's mask, on the flax paths
        used = convert_torch_state_dict(
            {n: torch.full(p.shape, float(grads[n] is not None))
             for n, p in state.model.named_parameters()})
        jmask = jpre.used_param_mask(params, task, jeng.cfg)
        got_used = {k: bool(v.flat[0]) for k, v in flat(used).items()}
        assert got_used == {k: bool(v) for k, v in flat(jmask).items()}, task
        if task_qa:
            assert "qa_loss" in losses and "qa_acc" in losses
            continue
        total, metrics, jgrads = jax_loss_and_grads(jeng, params, batch,
                                                    task)
        for k, v in metrics.items():
            if k != "qa_pred":
                np.testing.assert_allclose(float(losses[k]), float(v),
                                           rtol=1e-5, err_msg=f"{task} {k}")
        # gradients where both have one (JAX's are zeros elsewhere)
        tg = flat(convert_torch_state_dict(
            {n: g for n, g in grads.items() if g is not None}))
        jg = flat(jgrads)
        a = np.concatenate([tg[k].ravel() for k in sorted(tg)])
        b = np.concatenate([jg[k].ravel() for k in sorted(tg)])
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.99999, (task, cos)
        assert all(not jg[k].any() for k in jg if k not in tg), task


def test_six_step_round_robin_trajectory_matches_jax(setup, tmp_path):
    """Two round-robins of PretrainEngine.train_step against the JAX
    PretrainEngine at dropout 0 on host-masked batches; then the port's
    epoch checkpoint is read by the JAX package's load_pytree."""
    jeng, teng, params = setup
    jstate = replicate(jpre.TrainState.create(
        jax.tree.map(jnp.asarray, params), jeng.tx), jeng.mesh)
    tstate = teng.create_state(0, params)
    cj, ct = jnp.asarray(CENTROIDS), torch.from_numpy(CENTROIDS)
    j_losses, t_losses = [], []
    for k in range(6):
        task = teng.task_for_step(k)
        assert task == jeng.task_for_step(k) == TASKS[k % 3]
        batch = make_batch(10 + k)
        jstate, m = jeng.train_step(task)(jstate, jeng.place(batch),
                                          jax.random.PRNGKey(5), cj)
        j_losses.append(float(m["total_loss"]))
        t_losses.append(float(teng.train_step(tstate, batch, task,
                                              ct)["total_loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    final = flat(jax.device_get(jstate.params))
    got = flat(tstate.params())
    assert got.keys() == final.keys()
    for key in final:
        np.testing.assert_allclose(got[key], final[key], atol=6 * LR,
                                   rtol=0, err_msg=key)
    # per-parameter step counts: the skip of parameters a task misses
    counts = flat(jax.device_get(jstate.opt_state.count))
    tcounts = flat(convert_torch_state_dict(
        {n: torch.full(p.shape, float(tstate.opt.count[n]))
         for n, p in tstate.model.named_parameters()}))
    assert {k: int(v.flat[0]) for k, v in tcounts.items()} == {
        k: int(v) for k, v in counts.items()}
    assert tstate.opt.sched_step == 6
    path = os.path.join(tmp_path, epoch_ckpt_name(1))
    save_pytree(tstate.params(), path)
    back = flat(jax_load_pytree(path))
    assert back.keys() == got.keys()
    assert all(np.array_equal(back[k], got[k]) for k in got)


def test_on_device_masks_train_every_task():
    """Without host masks the step draws its masks from the generator:
    each task still trains, and the MLM labels mark what was masked."""
    _, teng, params = engines()
    state = teng.create_state(3, params)
    batch = {k: v for k, v in make_batch(4).items()
             if k not in ("masked_word_id", "word_label", "vis_mask")}
    placed = teng.place(batch)
    ids, _, feats, vis_mask, labels = tpre.build_inputs_and_labels(
        placed, torch.Generator().manual_seed(0), "vis_mask", teng.cfg,
        torch.from_numpy(CENTROIDS), torch.float32)
    counts = vis_mask.sum(1)
    assert ((counts >= 1) & (counts <= V)).all()
    assert torch.equal(labels["obj_labels"] >= 0, vis_mask > 0)
    for task in TASKS:
        m = teng.train_step(state, batch, task, torch.from_numpy(CENTROIDS))
        assert np.isfinite(float(m["total_loss"]))


class _BoxReader:
    """An in-memory bbox reader: {features, obj_id, boxes} per image."""

    def __init__(self, ids, seed):
        r = np.random.RandomState(seed)
        self.rows = {i: {"features": r.randn(4, FEAT).astype(np.float32),
                         "obj_id": r.randint(0, 9, 4).astype(np.int32),
                         "boxes": r.rand(4, 4).astype(np.float32)}
                     for i in ids}

    def __contains__(self, img_id):
        return img_id in self.rows

    def get(self, img_id):
        return self.rows[img_id]


def test_pretrain_dataset_batches_equal_the_jax_datasets(tmp_path):
    """PretrainDataset in clustering mode (with QA labels and the
    vis_mask substitution) and in bbox mode gives the JAX dataset's
    batches, negatives and QA draws included, from the same seed."""
    import pickle

    from xlxmert_tpu.data.answer_table import AnswerTable as JaxTable
    from xlxmert_tpu.data.datasets import PretrainDataset as JaxDataset
    from xlxmert_tpu.data.io import ClusterMap as JaxClusterMap
    from xlxmert_tpu.data.tokenization import Tokenizer as JaxTokenizer
    from xlxmert_tpu_torch.data.answer_table import AnswerTable
    from xlxmert_tpu_torch.data.datasets import PretrainDataset
    from xlxmert_tpu_torch.data.io import ClusterMap
    from xlxmert_tpu_torch.data.tokenization import Tokenizer

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog",
             "cat", "red", "ball", "runs", "what", "color"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    ids = [f"img{i}" for i in range(6)]
    corpus = [{"img_id": i, "img_source": ("mscoco" if n % 2 else "vg"),
               "sentf": {"mscoco": ["a dog runs", "what color"],
                         "vqa": ["what color ball"]},
               "labelf": {"vqa": [{"red": 0.6, "dog": 0.3}]}}
              for n, i in enumerate(ids)]
    table = [{"ans": a, "dsets": ["vqa"]} for a in ("red", "dog", "cat")]
    r = np.random.RandomState(0)
    clusters = {i: r.randint(0, N_CLUSTERS, V) for i in ids}
    with open(tmp_path / "c.pkl", "wb") as f:
        pickle.dump(clusters, f)
    reader = _BoxReader(ids, 1)
    for mode in ("clustering", "bbox"):
        kw = dict(max_text_length=L, grid_size=G, vis_mask_sources={"mscoco"})
        if mode == "clustering":
            t = PretrainDataset(corpus, Tokenizer(str(tmp_path / "vocab.txt")),
                                ClusterMap(clusters),
                                answer_table=AnswerTable(table), **kw)
            j = JaxDataset(corpus, JaxTokenizer(str(tmp_path / "vocab.txt")),
                           JaxClusterMap(tmp_path / "c.pkl"),
                           answer_table=JaxTable(table), **kw)
        else:
            boxes = {"mscoco": reader, "vg": reader}
            t = PretrainDataset(corpus, Tokenizer(str(tmp_path / "vocab.txt")),
                                bbox_readers=boxes, **kw)
            j = JaxDataset(corpus, JaxTokenizer(str(tmp_path / "vocab.txt")),
                           bbox_readers=boxes, **kw)
        assert len(t) == len(j) == 18
        tb = list(t.batches(4, shuffle=True, seed=3, drop_last=True))
        jb = list(j.batches(4, shuffle=True, seed=3, drop_last=True))
        assert len(tb) == len(jb) == 4
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), \
                    (mode, k)


def test_detector_vocabulary_heads_match_jax_at_fp32():
    """VisualObjHead without clusters: out_obj and out_attr Denses on the
    visual features, and the feature head, against the JAX model."""
    from xlxmert_tpu.models.xlxmert import XLxmert as JaxXLxmert
    from xlxmert_tpu_torch.core.convert import flax_to_state_dict

    kw = dict(CFG_KW, num_clusters=0, num_object_labels=7,
              num_attr_labels=5)
    heads = ("attr", "feat", "matched", "obj")
    r = np.random.RandomState(5)
    ids = r.randint(1, 111, (2, L)).astype(np.int32)
    feats = r.randn(2, 4, FEAT).astype(np.float32)
    pos = r.rand(2, 4, 4).astype(np.float32)
    jmodel = JaxXLxmert(JaxConfig(**kw))
    apply = jax.jit(lambda p: jmodel.apply(
        {"params": p}, ids, feats, pos, word_embedding_matrix=p["bert"][
            "embeddings"]["word_embeddings"]["embedding"], heads=heads))
    params = jax.jit(lambda k: jmodel.init(
        k, ids, feats, pos, word_embedding_matrix=np.zeros((111, 48)),
        heads=heads))(jax.random.PRNGKey(1))["params"]
    ref = apply(params)
    model = txl.XLxmert(LxmertConfig(**kw), heads=heads).eval()
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                          params)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(feats),
                    torch.from_numpy(pos), word_embedding_matrix=txl.
                    get_word_embedding_matrix(model), heads=heads)
    for key in ("obj_logits", "attr_logits", "feat_pred", "matched_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-5, rtol=0, err_msg=key)
