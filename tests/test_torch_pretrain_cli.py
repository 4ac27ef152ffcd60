"""The port's pre-training CLI (`xlxmert_tpu_torch.cli.pretrain`) end to
end on the CPU over a tiny synthetic data root (a json caption corpus,
a cluster-id pickle, a centroid table, a vocabulary): one epoch of the
task round-robin, the per-task evaluation, and the epoch checkpoint in
the JAX package's format, which the JAX model's parameter tree matches;
--bert_weights; and the JAX CLI's refusals."""
import json
import pickle

import numpy as np
import pytest

import jax

from xlxmert_tpu.core.checkpoint import load_pytree as jax_load_pytree
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.xlxmert import XLxmert as JaxXLxmert
from xlxmert_tpu_torch.cli.pretrain import main
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.tasks import pretrain as tpre

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "a", "dog", "cat", "runs", "sits", "red", "blue", "park", "ball"]
GRID, N_CLUSTERS, FEAT = 2, 10, 16
SHAPE = dict(vocab_size=len(VOCAB), hidden_size=32, num_attention_heads=2,
             intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
             visual_feat_dim=FEAT, num_qa_labels=3, num_clusters=N_CLUSTERS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ptworld")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    LxmertConfig(**SHAPE).save(str(root / "model.yaml"))
    img_ids = [f"img{i:02d}" for i in range(12)]
    (root / "lxmert").mkdir()
    corpus = [{"img_id": i, "sentf": {"mscoco": ["a dog runs",
                                                 "a red ball"]}}
              for i in img_ids]
    (root / "lxmert" / "mscoco_train.json").write_text(json.dumps(corpus))
    (root / "lxmert" / "mscoco_minival.json").write_text(
        json.dumps(corpus[:4]))
    rng = np.random.RandomState(0)
    np.save(root / "centroids.npy",
            rng.randn(N_CLUSTERS, FEAT).astype(np.float32))
    with open(root / "clusters.pkl", "wb") as f:
        pickle.dump({i: rng.randint(0, N_CLUSTERS, GRID * GRID)
                     for i in img_ids}, f)
    return root


def argv(world, out, *extra):
    return ["--taskMaskLM", "--taskObjPredict", "--taskMatched",
            "--visualLosses", "obj", "--vis_mask_predict", "--clustering",
            "--grid_model", "--grid_size", str(GRID),
            "--num_clusters", str(N_CLUSTERS), "--feat_dim", str(FEAT),
            "--epochs", "1", "--batchSize", "8", "--train", "mscoco_train",
            "--valid", "mscoco_minival", "--data_root", str(world),
            "--vocab", str(world / "vocab.txt"),
            "--centroid_path", str(world / "centroids.npy"),
            "--cluster_pkl", str(world / "clusters.pkl"),
            "--model_config", str(world / "model.yaml"),
            "--output", str(out), "--fp32", "--seed", "1",
            "--device", "cpu", *extra]


def jax_param_shapes():
    model = JaxXLxmert(JaxConfig(**SHAPE))
    ref = jax.eval_shape(lambda k: model.init(
        k, np.ones((2, 5), np.int32), np.zeros((2, GRID * GRID, FEAT)),
        np.zeros((2, GRID * GRID, 4)), attention_mask=np.ones((2, 5)),
        vis_mask=np.zeros((2, GRID * GRID)),
        centroids=np.zeros((N_CLUSTERS, FEAT)),
        word_embedding_matrix=np.zeros((len(VOCAB), 32)),
        heads=("lm", "matched", "obj")), jax.random.PRNGKey(0))["params"]
    return jax.tree.map(lambda s: s.shape, ref)


@pytest.mark.parametrize("route", ["xla", "pallas_blhd"])
def test_pretrain_cli_trains_evaluates_and_saves(world, route, monkeypatch):
    tasks = []
    step = tpre.PretrainEngine.train_step

    def record(self, state, batch, task, centroids):
        assert self.train_attention == route
        tasks.append(task)
        return step(self, state, batch, task, centroids)

    monkeypatch.setattr(tpre.PretrainEngine, "train_step", record)
    out = world / f"snap_{route}"
    main(argv(world, out, "--train_attention", route))
    # 24 examples, batch 8: 3 steps, one of each task
    assert tasks == ["vis_mask", "word_mask", "matched"]
    ck = jax_load_pytree(str(out / "Epoch01_LXRT.msgpack"))
    assert jax.tree.map(np.shape, ck) == jax_param_shapes()
    scalars = [json.loads(line) for line in open(out / "scalars.jsonl")]
    valid = [s for s in scalars if "valid/vis_mask" in s]
    assert valid and all(np.isfinite(valid[-1][f"valid/{t}"])
                         for t in ("vis_mask", "word_mask", "matched"))
    assert any("vis_mask/loss" in s for s in scalars)


def test_pretrain_cli_bert_init(world):
    torch = pytest.importorskip("torch")
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.BertConfig(vocab_size=len(VOCAB), hidden_size=32,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   intermediate_size=64)
    torch.manual_seed(0)
    bert = transformers.BertForPreTraining(tcfg)
    path = world / "bert_tiny.bin"
    torch.save(bert.state_dict(), str(path))
    out = world / "snap_bert"
    main(argv(world, out, "--bert_weights", str(path), "--dry"))
    assert "BERT init from" in (out / "log.txt").read_text()
    ck = jax_load_pytree(str(out / "Epoch01_LXRT.msgpack"))
    np.testing.assert_allclose(
        ck["bert"]["embeddings"]["word_embeddings"]["embedding"],
        bert.bert.embeddings.word_embeddings.weight.detach().numpy(),
        atol=1e-6)


@pytest.mark.parametrize("extra,message", [
    (["--visualLosses", "obj,attr"], "attr labels"),
    (["--visualLosses", "obj,feat"], "exact-feature source"),
])
def test_pretrain_cli_refuses_what_no_data_path_feeds(world, extra, message):
    with pytest.raises(SystemExit, match=message):
        main(argv(world, world / "snap_refused", *extra))


def test_pretrain_cli_refuses_non_clustering_without_features(world):
    args = [a for a in argv(world, world / "snap_refused")
            if a != "--clustering"]
    with pytest.raises(SystemExit, match="non-clustering"):
        main(args)


def test_pretrain_cli_full_state_is_not_ported_yet(world):
    with pytest.raises(NotImplementedError, match="A11"):
        main(argv(world, world / "snap_full", "--save_full_state"))


def test_pretrain_cli_bbox_path(world):
    """The non-clustering bbox path: features, detector ids and boxes
    from a boxes h5 (BboxFeatureReader), the detector-vocabulary obj head
    and the feature regression; the checkpoint matches the JAX model's
    tree for the same heads."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(7)
    path = world / "boxes4.h5"
    with h5py.File(path, "w") as f:
        for i in range(12):
            g = f.create_group(f"img{i:02d}")
            g.create_dataset("features",
                             data=rng.randn(4, FEAT).astype(np.float32))
            g.create_dataset("obj_id", data=rng.randint(0, 5, 4))
            g.create_dataset("boxes", data=rng.rand(4, 4).astype(
                np.float32) * 64)
            g.create_dataset("img_w", data=64)
            g.create_dataset("img_h", data=64)
    out = world / "snap_bbox"
    args = [a for a in argv(world, out) if a not in ("--clustering",
                                                     "--grid_model")]
    args[args.index("obj")] = "obj,feat"
    main(args + ["--target_obj_id", "--feed_exact_feat", "--n_boxes", "4",
                 "--bbox_h5", str(path)])
    ck = jax_load_pytree(str(out / "Epoch01_LXRT.msgpack"))
    shape = dict(SHAPE, num_clusters=0)
    model = JaxXLxmert(JaxConfig(**shape))
    ref = jax.eval_shape(lambda k: model.init(
        k, np.ones((2, 5), np.int32), np.zeros((2, 4, FEAT)),
        np.zeros((2, 4, 4)), attention_mask=np.ones((2, 5)),
        vis_mask=np.zeros((2, 4)),
        word_embedding_matrix=np.zeros((len(VOCAB), 32)),
        heads=("feat", "lm", "matched", "obj")),
        jax.random.PRNGKey(0))["params"]
    assert jax.tree.map(np.shape, ck) == jax.tree.map(lambda s: s.shape, ref)
    assert "out_obj" in ck["obj_predict_head"]


def test_pretrain_cli_load_resumes_and_refuses_a_full_state(world):
    """--load of an epoch checkpoint overlays it and resumes at its epoch
    (Epoch01 with --epochs 1: nothing left to train); a full-state tree
    is refused until its exact resume is ported."""
    from xlxmert_tpu_torch.core.checkpoint import save_pytree
    from xlxmert_tpu_torch.core.convert import extract_centroids

    first = world / "snap_first"
    main(argv(world, first, "--dry"))
    ck = jax_load_pytree(str(first / "Epoch01_LXRT.msgpack"))
    out = world / "snap_resumed"
    main(argv(world, out, "--load", str(first / "Epoch01_LXRT.msgpack")))
    assert "resumed from" in (out / "log.txt").read_text()
    assert not (out / "Epoch01_LXRT.msgpack").exists()
    full = world / "Epoch01_FULL.msgpack"
    save_pytree({"params": ck, "opt_state": {}, "step": np.int32(3)},
                str(full))
    with pytest.raises(NotImplementedError, match="A11"):
        main(argv(world, world / "snap_full_load", "--load", str(full)))
    table = np.ones((3, FEAT), np.float32)
    assert extract_centroids({"module.vis_emb.weight": table}) is table
    assert extract_centroids({"bert.x": table}) is None
