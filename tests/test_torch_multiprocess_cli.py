"""The port's CLIs launched as 2 processes with torchrun's environment
on the CPU (gloo over localhost TCP, each spawn with its own timeout):
the VQA CLI trains on each rank's shard, merges the evaluation through
<output>/eval_shards and writes once from rank 0; the pre-training CLI
with --mesh_shape 1,2 --mesh_axis_names data,model (tensor parallelism)
writes a FULL checkpoint in the single process's layout, equal to the
single process's run (dropout 0.1 and on-device masks: the model group
draws the single process's stream), and resumes from a single
process's FULL; the GAN CLI's first (D, G) pair on paths[rank::2] at 2
images a rank equals one process's pair on the 4 images."""
import json

import numpy as np
import pytest

import jax

import test_torch_finetune_cli as ftc
import test_torch_pretrain_cli as ptc
import test_torch_train_generator_cli as tgc
import torch_rank_bodies as bodies
from xlxmert_tpu_torch.core.checkpoint import load_pytree
from xlxmert_tpu_torch.parallel.launch import spawn

SPAWN_TIMEOUT = 180
GAN_LR = 4e-4             # cli/train_generator's --g_lr default
world = ftc.world          # the fine-tuning fixture's data root


def test_vqa_cli_on_two_ranks(world):
    out = world / "snap_vqa_2ranks"
    argv = (["--train", "train", "--valid", "minival", "--epochs", "1"]
            + ftc._common(world, out))
    argv[argv.index("--batchSize") + 1] = "4"        # a rank's batch
    test = ["--test", "minival", "--load", str(out / "BEST.msgpack"),
            "--serve_int8"] + ftc._common(world, out)
    spawn(bodies.cases, 2, ([("run_cli", dict(
        module="xlxmert_tpu_torch.cli.vqa", argv=argv)),
        ("run_cli", dict(module="xlxmert_tpu_torch.cli.vqa", argv=test))],),
        timeout=SPAWN_TIMEOUT, init="env", device="cpu")
    assert (out / "LAST.msgpack").exists() and (out / "BEST.msgpack").exists()
    log = (out / "log.txt").read_text()
    assert log.count("epoch 0: valid") == 1          # rank 0 alone logs
    assert sorted(p.name for p in (out / "eval_shards").iterdir()) == [
        "predict_shard0.json", "predict_shard1.json"]
    preds = json.loads((out / "vqa_minival_predict.json").read_text())
    assert sorted(p["question_id"] for p in preds) == list(range(8))


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    # the pre-training CLI test's data root, built by its fixture's body
    root = ptc.world.__wrapped__(tmp_path_factory)
    single, tp = root / "single", root / "tp"
    ptc.main(ptc.argv(root, single, "--save_full_state"))
    mesh = ["--mesh_shape", "1,2", "--mesh_axis_names", "data,model"]
    resumed = root / "tp_resumed"
    spawn(bodies.cases, 2, ([
        ("run_cli", dict(module="xlxmert_tpu_torch.cli.pretrain",
                         argv=ptc.argv(root, tp, "--save_full_state",
                                       *mesh))),
        ("run_cli", dict(module="xlxmert_tpu_torch.cli.pretrain",
                         argv=ptc.argv(root, resumed, "--save_full_state",
                                       "--epochs", "2", "--load",
                                       str(single / "Epoch01_FULL.msgpack"),
                                       *mesh)))],),
        timeout=SPAWN_TIMEOUT, init="env", device="cpu")
    return single, tp, resumed


def test_pretrain_cli_tensor_parallel_full_state(pretrain_runs):
    single, tp, resumed = pretrain_runs
    want = jax.tree_util.tree_flatten_with_path(
        load_pytree(str(single / "Epoch01_FULL.msgpack")))[0]
    got = jax.tree_util.tree_flatten_with_path(
        load_pytree(str(tp / "Epoch01_FULL.msgpack")))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4,
                                   err_msg=str(path))
    log = (resumed / "log.txt").read_text()
    assert "exact-resumed full train state" in log
    full = load_pytree(str(resumed / "Epoch02_FULL.msgpack"))
    assert int(full["step"]) == 6
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(full["params"]))


def test_gan_cli_on_two_ranks(tmp_path, monkeypatch):
    """The noise scales start at 0, so the first pair draws no noise on
    either side, and both runs see the same 4 images: the pair's global
    metrics (every loss term of the D- and the G-step) equal the single
    process's, and so does G_0 at lr / 40. Two kinds of leaf take a first
    Adam update of about +-lr that no shared signal decides, and are held
    at 2 lr: the noise scales (their gradient is the drawn noise against
    the upstream gradient, and a rank draws other noise than the single
    process) and conv1's bias (cbn2's batch norm removes it: its exact
    gradient is 0, so the update scales rounding)."""
    monkeypatch.setitem(__import__("sys").modules,
                        "torch.utils.tensorboard", None)
    base = tgc.write_data(tmp_path)
    one = base + ["--epochs", "1"]
    first = tgc.cli.main(one)["last"]
    single = load_pytree(str(tmp_path / "snap_g" / "G_0.msgpack"))
    two = [a.replace("snap_g", "snap_g2") for a in one]
    two[two.index("--batch_size") + 1] = str(tgc.IMAGES // 2)
    out = spawn(bodies.run_cli, 2, ("xlxmert_tpu_torch.cli.train_generator",
                                    two),
                timeout=SPAWN_TIMEOUT, init="env", device="cpu")
    assert [o["pairs"] for o in out] == [1, 1]
    assert out[0]["last"] == out[1]["last"]          # global metrics
    assert sorted(out[0]["last"]) == sorted(first)
    for k, v in first.items():
        np.testing.assert_allclose(out[0]["last"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got = load_pytree(str(tmp_path / "snap_g2" / "G_0.msgpack"))
    want = dict(tgc.leaves(single))
    free = [p for p, _ in tgc.leaves(got)
            if "/noise" in p or p.endswith("/conv1/bias")]
    assert len(free) == 6                     # 2 resblocks x 3 leaves
    for p, x in tgc.leaves(got):
        bar = 2 * GAN_LR if p in free else GAN_LR / 40
        np.testing.assert_allclose(x, want[p], rtol=0, atol=bar, err_msg=p)
