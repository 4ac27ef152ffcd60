"""The port's fine-tuning CLIs (`xlxmert_tpu_torch.cli.vqa`, `.nlvr2`) end
to end on the CPU over tiny HDF5 fixtures: train an epoch, write the
checkpoints in the JAX package's format, and write the test dumps
through the exact model and through --serve_int8."""
import json

import numpy as np
import pytest

import jax

from xlxmert_tpu.core.checkpoint import load_pytree as jax_load_pytree
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.task_heads import NLVR2Model as JaxNLVR2Model
from xlxmert_tpu.models.task_heads import VQAModel as JaxVQAModel
from xlxmert_tpu_torch.core.checkpoint import load_pytree
from xlxmert_tpu_torch.core.config import LxmertConfig

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "a", "dog", "cat", "runs", "sits", "red", "blue", "park", "ball"]
GRID = 2
SHAPE = dict(vocab_size=len(VOCAB), hidden_size=32, num_attention_heads=2,
             intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
             visual_feat_dim=16)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("ftworld")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    LxmertConfig(**SHAPE).save(str(root / "model.yaml"))
    img_ids = [f"img{i:02d}" for i in range(12)]
    rng = np.random.RandomState(0)
    (root / "mscoco_imgfeat").mkdir()
    (root / "nlvr2_imgfeat").mkdir()
    for path in (root / "mscoco_imgfeat" / "maskrcnn_train_grid2.h5",
                 root / "mscoco_imgfeat" / "maskrcnn_valid_grid2.h5",
                 root / "nlvr2_imgfeat" / "maskrcnn_train_grid2.h5",
                 root / "nlvr2_imgfeat" / "maskrcnn_valid_grid2.h5"):
        with h5py.File(path, "w") as f:
            for i in img_ids:
                f.create_group(i).create_dataset(
                    "features", data=rng.randn(GRID, GRID, 16).astype(
                        np.float32))
    (root / "vqa").mkdir()
    words = ["a dog runs in a park", "a red ball", "a cat sits"]
    vqa = [{"question_id": q, "img_id": img_ids[q % 12],
            "sent": words[q % 3],
            "label": {["dog", "red", "cat"][q % 3]: 1.0}} for q in range(16)]
    (root / "vqa" / "train.json").write_text(json.dumps(vqa))
    (root / "vqa" / "minival.json").write_text(json.dumps(vqa[:8]))
    (root / "vqa" / "trainval_ans2label.json").write_text(
        json.dumps({"dog": 0, "cat": 1, "red": 2}))
    (root / "vqa" / "trainval_label2ans.json").write_text(
        json.dumps(["dog", "cat", "red"]))
    (root / "nlvr2").mkdir()
    data = [{"uid": f"u{q}", "img0": img_ids[q % 12],
             "img1": img_ids[(q + 3) % 12], "sent": words[q % 3],
             "label": q % 2, "identifier": f"id-{q}"} for q in range(12)]
    (root / "nlvr2" / "train.json").write_text(json.dumps(data))
    (root / "nlvr2" / "valid.json").write_text(json.dumps(data[:6]))
    return root


def _common(world, out):
    return ["--batchSize", "8", "--data_root", str(world),
            "--vocab", str(world / "vocab.txt"),
            "--model_config", str(world / "model.yaml"),
            "--grid_size", str(GRID), "--output", str(out), "--fp32",
            "--device", "cpu"]


def _same_structure(ours, jax_model, feats_shape, pos_shape):
    ids = np.ones((2, 5), np.int32)
    ref = jax.eval_shape(lambda k: jax_model.init(
        k, ids, np.zeros(feats_shape, np.float32),
        np.zeros(pos_shape, np.float32), attention_mask=np.ones((2, 5))),
        jax.random.PRNGKey(0))["params"]
    assert jax.tree.structure(ref) == jax.tree.structure(ours)
    for r, o in zip(jax.tree.leaves(ref), jax.tree.leaves(ours)):
        assert r.shape == o.shape and o.dtype == np.float32


def test_vqa_cli_trains_writes_jax_checkpoints_and_dumps(world):
    from xlxmert_tpu_torch.cli.vqa import main

    out = world / "snap_vqa"
    main(["--train", "train", "--valid", "minival", "--epochs", "2",
          "--train_attention", "pallas_blhd", "--update_freq", "2"]
         + _common(world, out))
    for name in ("LAST.msgpack", "BEST.msgpack"):
        assert (out / name).exists()
    log = (out / "log.txt").read_text()
    assert "epoch 1: valid" in log and "best valid" in log
    assert len((out / "scalars.jsonl").read_text().splitlines()) == 2
    # the port's checkpoint is the JAX package's: the same bytes decode
    # to the same tree in both loaders, shaped as the flax VQAModel
    ours, theirs = load_pytree(str(out / "BEST.msgpack")), jax_load_pytree(
        str(out / "BEST.msgpack"))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, np.asarray(b))
    _same_structure(theirs, JaxVQAModel(JaxConfig(**SHAPE), num_answers=3),
                    (2, 4, 16), (2, 4, 4))

    test = ["--test", "minival", "--load", str(out / "BEST.msgpack")]
    main(test + _common(world, out))
    preds = json.loads((out / "vqa_minival_predict.json").read_text())
    assert sorted(p["question_id"] for p in preds) == list(range(8))
    assert all(p["answer"] in ("dog", "cat", "red") for p in preds)
    main(test + ["--serve_int8"] + _common(world, out))
    preds8 = json.loads((out / "vqa_minival_predict.json").read_text())
    assert len(preds8) == 8
    agree = np.mean([a["answer"] == b["answer"]
                     for a, b in zip(preds, preds8)])
    assert agree >= 0.75, agree


def test_nlvr2_cli_trains_and_dumps_csv(world):
    from xlxmert_tpu_torch.cli.nlvr2 import main

    out = world / "snap_nlvr2"
    main(["--train", "train", "--valid", "valid", "--epochs", "1"]
         + _common(world, out))
    best = jax_load_pytree(str(out / "BEST.msgpack"))
    _same_structure(best, JaxNLVR2Model(JaxConfig(**SHAPE)),
                    (2, 2, 4, 16), (2, 2, 4, 4))
    for extra in ([], ["--serve_int8"]):
        main(["--test", "valid", "--load", str(out / "BEST.msgpack")]
             + extra + _common(world, out))
        lines = (out / "nlvr2_valid_predict.csv").read_text().splitlines()
        assert sorted(line.split(",")[0] for line in lines) == sorted(
            f"id-{q}" for q in range(6))
        assert all(line.split(",")[1] in ("True", "False")
                   for line in lines)


def test_cli_flags_without_effect_and_not_ported(world, tmp_path):
    from xlxmert_tpu_torch.cli.args import base_parser, to_finetune_config
    from xlxmert_tpu_torch.cli.gqa import main as gqa_main
    from xlxmert_tpu_torch.cli.vqa import main

    ns = base_parser().parse_args(["--rng_impl", "threefry2x32",
                                   "--multiGPU"])
    cfg = to_finetune_config(ns, "gqa")
    assert cfg.task == "gqa" and cfg.mixed_precision and ns.device == "cuda"
    # --profile: accepted without effect, as the JAX fine-tuning CLI does
    main(["--profile", "2", "--train", "train", "--valid", "minival",
          "--epochs", "1"] + _common(world, tmp_path))
    assert (tmp_path / "LAST.msgpack").exists()
    assert not (tmp_path / "profile").exists()
    assert callable(gqa_main)
