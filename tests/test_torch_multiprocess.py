"""The port's process-group helpers (parallel/mesh.py), without a
process group or on spawned gloo ranks with their own timeout:
maybe_initialize_multihost's gating as tests/test_multihost.py pins the
JAX package's, a failed explicit rendezvous raising, shard_batch's
per-rank slices and divisibility errors, `shard` as a disjoint cover on
every dataset class (the JAX package's slices), the ranks' device, and
spawn's failure and timeout reporting."""
import functools
import operator
import subprocess

import numpy as np
import pytest
import torch

from xlxmert_tpu.data import datasets as jds
from xlxmert_tpu.data.tokenization import Tokenizer as JaxTokenizer
from xlxmert_tpu_torch.data import datasets as tds
from xlxmert_tpu_torch.data.tokenization import Tokenizer
from xlxmert_tpu_torch.parallel import mesh as pmesh
from xlxmert_tpu_torch.parallel.launch import free_port, spawn
from xlxmert_tpu_torch.utils.device import resolve_device

LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
               "XLXMERT_MULTIHOST", "LOCAL_WORLD_SIZE")


def global_batch(B=16):
    r = np.random.RandomState(0)
    return {"ids": r.randint(0, 100, (B, 12)).astype(np.int32),
            "feats": r.randn(B, 4, 8).astype(np.float32)}


def test_shard_batch_slices_reassemble_the_global_batch():
    batch = global_batch()
    for n in (1, 2, 4):
        parts = [pmesh.shard_batch(batch, pmesh.Mesh({"data": n},
                                                     index={"data": i}),
                                   process_local=False) for i in range(n)]
        for k in batch:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), batch[k])
    # process-local: each rank's own slice, as given
    mine = pmesh.shard_batch(batch, pmesh.Mesh({"data": 4}),
                             process_local=True)
    assert mine is batch


def test_shard_batch_divisibility_error():
    with pytest.raises(ValueError, match="must be divisible by the "
                       "data-axis size 2"):
        pmesh.shard_batch({"x": np.zeros((9, 3))},
                          pmesh.Mesh({"data": 2}), process_local=False)


def test_make_mesh_refuses_a_wrong_layout():
    assert pmesh.make_mesh().shape == {"data": 1}
    assert pmesh.make_mesh((), ("data", "model")).shape == {"data": 1,
                                                            "model": 1}
    with pytest.raises(ValueError, match="does not hold"):
        pmesh.make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="mesh axes"):
        pmesh.make_mesh((1,), ("model",))


def test_maybe_initialize_multihost_gating(monkeypatch):
    """No launch environment: no process group; torchrun's WORLD_SIZE > 1
    with RANK, LOCAL_RANK and MASTER_ADDR, SLURM_NTASKS > 1, or
    XLXMERT_MULTIHOST=1: initialize; WORLD_SIZE alone (no rendezvous
    variables) does not."""
    calls = []
    monkeypatch.setattr(pmesh, "initialize_multihost",
                        lambda **kw: calls.append(kw) or "gloo")
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    assert pmesh.maybe_initialize_multihost("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert pmesh.maybe_initialize_multihost("cpu") is None
    assert calls == []
    for v, x in (("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost")):
        monkeypatch.setenv(v, x)
    assert pmesh.maybe_initialize_multihost("cpu") == "gloo"
    assert calls == [{"device": "cpu"}]
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    pmesh.maybe_initialize_multihost("cpu")
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setenv("XLXMERT_MULTIHOST", "1")
    pmesh.maybe_initialize_multihost("cpu")
    assert len(calls) == 3
    assert not pmesh.initialized() and pmesh.world_size() == 1


def test_explicit_rendezvous_failure_raises(monkeypatch):
    """Rank 1 of 2 against a port where no rank 0 listens: raises after
    the timeout instead of hanging or falling back to one process."""
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(Exception):
        pmesh.initialize_multihost(f"tcp://127.0.0.1:{free_port()}", 2, 1,
                                   device="cpu", timeout=2)
    assert not pmesh.initialized()
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pmesh.initialize_multihost(device="cpu")


def test_backend_choice():
    assert pmesh.choose_backend("cpu", 2)[0] == "gloo"
    if not torch.cuda.is_available():
        # 2 ranks, no card of their own: gloo (NCCL takes one a device)
        assert pmesh.choose_backend("cuda", 2)[0] == "gloo"


def test_a_rank_takes_its_local_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device("cpu") == torch.device("cpu")


def _vocab():
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "q", "a", "b"] \
        + [str(i) for i in range(10)]
    return {t: i for i, t in enumerate(words)}


@pytest.mark.parametrize("kind", ["vqa", "gqa", "nlvr2", "pretrain"])
def test_dataset_shard_is_a_disjoint_cover(kind):
    """Every class's shard(rank, world): the ranks' parts are disjoint
    and cover the data, and each equals the JAX class's part."""
    n, world = 23, 4
    tok, jtok = Tokenizer(_vocab()), JaxTokenizer(_vocab())

    def build(mod, t):
        if kind in ("vqa", "gqa"):
            cls = mod.VQADataset if kind == "vqa" else mod.GQADataset
            data = [{"question": f"q {i}", "img_id": f"i{i}", "label": {},
                     "question_id": i} for i in range(n)]
            return cls(data, t, None, {}, [], max_text_length=8,
                       grid_size=2), "data", "question_id"
        if kind == "nlvr2":
            data = [{"uid": i, "sent": "a b", "img0": "x", "img1": "y",
                     "label": 0, "identifier": f"d{i}"} for i in range(n)]
            return mod.NLVR2Dataset(data, t, None, max_text_length=8,
                                    grid_size=2), "data", "uid"
        corpus = [{"img_id": f"i{i}", "sentf": {"mscoco": ["a b"]},
                   "labelf": {}} for i in range(n)]
        every_image = type("Every", (), {"__contains__": lambda s, k: True})
        return mod.PretrainDataset(corpus, t, feat_reader=every_image(),
                                   max_text_length=8, grid_size=2), \
            "examples", None

    seen = []
    for r in range(world):
        ds, attr, key = build(tds, tok)
        jds_, _, _ = build(jds, jtok)
        ds.shard(r, world)
        jds_.shard(r, world)
        part = getattr(ds, attr)
        assert part == getattr(jds_, attr)
        seen.extend(d[key] if key else d["img_id"] for d in part)
    want = list(range(n)) if kind != "pretrain" else [f"i{i}"
                                                      for i in range(n)]
    assert sorted(seen, key=str) == sorted(want, key=str)


def test_spawn_reports_a_failing_rank_and_a_hung_one():
    """Rank bodies from modules without JAX (a spawned rank re-imports
    the module of its function): 1 / rank fails on rank 0; `sleep 20`
    outlives the timeout."""
    with pytest.raises(RuntimeError, match="(?s)rank 0:.*division by zero"):
        spawn(functools.partial(operator.truediv, 1), 2, init="none",
              timeout=60, device="cpu")
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn(functools.partial(subprocess.run, ["sleep", "20"]), 2,
              init="none", timeout=6, device="cpu")


def test_cli_mesh_flags_reach_the_config():
    from xlxmert_tpu_torch.cli.args import base_parser, to_train_config

    ns = base_parser().parse_args(["--mesh_shape", "2,2",
                                   "--mesh_axis_names", "data,model"])
    cfg = to_train_config(ns)
    assert cfg.mesh_shape == (2, 2)
    assert cfg.mesh_axis_names == ("data", "model")
    default = to_train_config(base_parser().parse_args([]))
    assert default.mesh_shape == () and default.mesh_axis_names == ("data",)


def test_engines_refuse_an_axis_they_do_not_use():
    """A mesh axis an engine does not shard over would leave its ranks
    replicas that never meet: fine-tuning and the GAN take "data" only,
    pre-training "data" and "model"."""
    from xlxmert_tpu_torch.core.config import (
        FinetuneConfig, GanConfig, LxmertConfig, TrainConfig,
    )
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine
    from xlxmert_tpu_torch.tasks.train_generator import GanEngine

    model = pmesh.Mesh({"data": 1, "model": 2})
    pipe = pmesh.Mesh({"data": 1, "pipe": 2})
    with pytest.raises(ValueError, match="fine-tuning"):
        FinetuneEngine(FinetuneConfig(), 3, LxmertConfig(), device="cpu",
                       mesh=model)
    with pytest.raises(ValueError, match="GAN training"):
        GanEngine(GanConfig(), device="cpu", mesh=model)
    with pytest.raises(ValueError, match="pre-training"):
        PretrainEngine(TrainConfig(), device="cpu", mesh=pipe)
    assert PretrainEngine(TrainConfig(), device="cpu",
                          mesh=model).tp is not None
