"""The port's pre-training step held to the plain fp32 reference of the
benchmark (portbench/reference/xlxmert_pretrain.py) on the CPU at a
small size, without dropout and at dropout 0.1 (the masks the program
draws recorded and given to the reference, as the benchmark judges its
steps): each task's loss, every parameter's gradient, the set of
parameters without one and the parameters after one AdamW update; the
step function of cli/pretrain against pretrain()'s own loop; and the
step's stage spans and counters (utils/profiling)."""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from portbench.paths.pretrain_steps import (  # noqa: E402
    drops_of, recorded_dropout,
)
from portbench.reference import xlxmert_pretrain as ref  # noqa: E402
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401
from xlxmert_tpu_torch.cli.pretrain import pretrain, pretrain_step  # noqa: E402,E501
from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig  # noqa: E402,E501
from xlxmert_tpu_torch.data.datasets import PretrainDataset  # noqa: E402
from xlxmert_tpu_torch.data.io import ClusterMap  # noqa: E402
from xlxmert_tpu_torch.tasks.pretrain import (  # noqa: E402
    PretrainEngine, used_param_mask,
)
from xlxmert_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.usefixtures("share_the_cores")

VOCAB, K, FEAT, GRID, B, L = 60, 12, 16, 2, 6, 8
HEADS = 2
# weight decay far above the recipe's 0.01, so that the decay term
# (lr wd p) is a fifth of an update (about lr) and the decay's order
# after the update (lr wd u) a hundredth of it: both above the update
# check's 1e-3
WD = 10.0
STAGES = {"xlt.train.inputs", "xlt.train.forward", "xlt.train.loss",
          "xlt.train.backward", "xlt.train.clip", "xlt.train.optimizer"}


def model_cfg(dropout=0.0):
    return LxmertConfig(vocab_size=VOCAB, hidden_size=32,
                        num_attention_heads=HEADS, intermediate_size=64,
                        l_layers=2, x_layers=2, r_layers=1,
                        visual_feat_dim=FEAT, max_position_embeddings=16,
                        num_clusters=K, hidden_dropout_prob=dropout,
                        attention_probs_dropout_prob=dropout)


def train_cfg(**kw):
    base = dict(batch_size=B, max_text_length=L, grid_size=GRID,
                num_clusters=K, feat_dim=FEAT, clustering=True,
                visual_losses="obj", vis_mask_predict=True, lr=1e-3,
                weight_decay=WD, mixed_precision=False, seed=5)
    base.update(kw)
    return TrainConfig(**base)


def engine(route="pallas_blhd", dropout=0.0, **kw):
    eng = PretrainEngine(train_cfg(**kw), model_cfg(dropout),
                         total_steps=20, train_attention=route,
                         device="cpu")
    return eng, eng.create_state(11)


def host_batch(seed):
    """A loader-like batch with injected masks: word_mask reads the
    masked caption and its labels, matched another caption for some
    pairs, vis_mask the substitute caption and grid with its cell mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, (B, L))
    ids[:, 0] = 2
    n = rng.integers(3, L + 1, B)
    ids[np.arange(L)[None] >= n[:, None]] = 0
    ids[np.arange(B), n - 1] = 3
    chosen = (rng.random((B, L)) < 0.3) & (ids > 3)
    chosen[0, 1] = True
    swap = rng.random(B) < 0.5
    V = GRID * GRID
    vis = (rng.random((B, V)) < 0.5).astype(np.float32)
    vis[:, 0] = 1
    return {"word_id": ids, "other_word_id": np.where(
                swap[:, None], np.roll(ids, 1, 0), ids),
            "matched_label": (~swap).astype(np.int64),
            "cluster_id": rng.integers(0, K, (B, V)),
            "coco_word_id": np.roll(ids, 2, 0),
            "coco_cluster_id": rng.integers(0, K, (B, V)),
            "masked_word_id": np.where(chosen, 4, ids),
            "word_label": np.where(chosen, ids, -1), "vis_mask": vis}


def reference_inputs(batch, task):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if task == "word_mask":
        return ref.Inputs(t["masked_word_id"], t["cluster_id"], None,
                          t["word_label"])
    if task == "matched":
        return ref.Inputs(t["other_word_id"], t["cluster_id"], None,
                          t["matched_label"])
    vm = t["vis_mask"] > 0
    grid = t["coco_cluster_id"]   # --vis_mask_COCOVG_only's substitute
    return ref.Inputs(t["coco_word_id"], grid, vm,
                      torch.where(vm, grid, -100))


def rel(got, want, scale):
    """||got - want|| over the larger of ||want|| and `scale`."""
    return float((got - want).norm()) / max(float(want.norm()), scale)


@pytest.fixture(scope="module", params=[0.0, 0.1],
                ids=["no-dropout", "dropout"])
def steps(request):
    """Four steps of the round-robin (the first one's learning rate is
    the warm-up's 0), then one judged step of each task, each beside the
    reference computed from the parameters and AdamW state before it and
    the dropout masks the step drew."""
    torch.manual_seed(0)
    rate = request.param
    eng, state = engine(dropout=rate)
    rates = {"hidden_dropout_prob": rate,
             "attention_probs_dropout_prob": rate}
    centroids = torch.randn(K, FEAT)
    pos = ref.box_position(GRID)
    h = ref.Hyper(1e-3, 20, 0.05, WD, 1.0, 1e-6)
    for i in range(4):
        eng.train_step(state, host_batch(100 + i), eng.task_for_step(i),
                       centroids)
    out = {}
    for i in range(4, 7):
        task = eng.task_for_step(i)
        batch = host_batch(200 + i)
        opt = state.opt
        before = {k: p.detach().clone() for k, p in opt.params.items()}
        m, v, counts = dict(opt.m), dict(opt.v), dict(opt.count)
        sched, seen, keeps = opt.sched_step, {}, []
        update = opt.step

        def spy(grads, used=None, **kw):
            seen["grads"] = {k: g if k in used else None
                             for k, g in grads.items()}
            return update(grads, used=used, **kw)

        opt.step = spy
        with recorded_dropout(state.model, keeps):
            loss = float(eng.train_step(state, batch, task,
                                        centroids)["total_loss"])
        del opt.step
        # dropout at every site the reference takes one, or none
        assert bool(keeps) == (rate > 0)
        r_loss, r_grads = ref.loss_and_grads(
            before, task, reference_inputs(batch, task), centroids, pos,
            HEADS, block=4,
            drops=drops_of(keeps, rates, torch.float32) if rate else None)
        out[task] = dict(
            loss=loss, grads=seen["grads"], before=before,
            after={k: p.detach().clone() for k, p in opt.params.items()},
            r_loss=r_loss, r_grads=r_grads,
            r_after=ref.adamw(before, r_grads, m, v, counts, sched, h))
    return out


@pytest.mark.parametrize("task", ref.TASKS)
def test_loss_matches_the_reference(steps, task):
    s = steps[task]
    # fp32 both sides; the port's LayerNorm takes E[x^2] - E[x]^2 and
    # the reference the two-pass variance: rounding of a few ulps
    assert s["loss"] == pytest.approx(s["r_loss"], rel=1e-5)


@pytest.mark.parametrize("task", ref.TASKS)
def test_no_gradient_sets_match_the_reference(steps, task):
    s = steps[task]
    none = {k for k, g in s["grads"].items() if g is None}
    assert none == {k for k, g in s["r_grads"].items() if g is None}
    assert none    # each task leaves some parameters
    # ... and the port's rule on names agrees
    assert none == set(s["grads"]) - used_param_mask(
        s["grads"], task, train_cfg())
    for k in none:
        assert torch.equal(s["after"][k], s["before"][k]), k


@pytest.mark.parametrize("task", ref.TASKS)
def test_every_gradient_matches_the_reference(steps, task):
    s = steps[task]
    used = [k for k, g in s["r_grads"].items() if g is not None]
    whole = math.sqrt(sum(float(s["r_grads"][k].norm()) ** 2
                          for k in used))
    for k in used:
        # fp32 both sides, a few ulps an op through 5 layers and back:
        # 1e-4 relative, against at least 1e-4 of the whole gradient
        # (the attention key biases' exact gradient is 0: softmax
        # ignores a shift, so both sides hold rounding noise there)
        assert rel(s["grads"][k], s["r_grads"][k], 1e-4 * whole) < 1e-4, k


@pytest.mark.parametrize("task", ref.TASKS)
def test_parameters_after_the_update_match_the_reference(steps, task):
    s = steps[task]
    for k, g in s["r_grads"].items():
        if g is None:
            continue
        d = s["after"][k] - s["before"][k]
        rd = s["r_after"][k] - s["before"][k]
        # the update's size is about lr an element; its relative error
        # follows the gradients' (1e-4) and the schedule's float32
        # rounding (the port) against float64 (the reference)
        assert rel(d, rd, 1e-3 * 1e-3 * math.sqrt(d.numel())) < 1e-3, k


def test_the_step_function_is_pretrains_loop(tmp_path):
    """cli/pretrain.pretrain() over two rounds (six steps, with masks and
    dropout drawn by the program) and `pretrain_step` over the loader's
    same batches give the same losses and the same parameters."""

    class Tok:
        def encode_batch(self, sents, max_len):
            out = np.zeros((len(sents), max_len), np.int64)
            for i, s in enumerate(sents):
                row = [2] + [5 + int(w) for w in s.split()] + [3]
                out[i, :min(max_len, len(row))] = row[:max_len]
            return out

    class Log:
        def scalars(self, *a):
            pass

        def info(self, *a):
            pass

    rng = np.random.RandomState(3)
    clusters = ClusterMap({f"i{j}": rng.randint(0, K, GRID * GRID)
                           for j in range(12)})
    corpus = [{"img_id": f"i{j}", "sentf": {"mscoco": [
        " ".join(str(w) for w in rng.randint(0, VOCAB - 5, 4))]}}
        for j in range(12)]
    kw = dict(max_text_length=L, grid_size=GRID,
              vis_mask_sources={"mscoco", "vg"})
    train = PretrainDataset(corpus, Tok(), clusters, **kw)
    valid = PretrainDataset(corpus[:B], Tok(), clusters, **kw)
    centroids = torch.from_numpy(rng.randn(K, FEAT).astype(np.float32))
    cfg = train_cfg(epochs=1, output=str(tmp_path), batch_size=2,
                    vis_mask_COCOVG_only=True)
    eng = PretrainEngine(cfg, model_cfg(0.1), total_steps=6,
                         train_attention="pallas_blhd", device="cpu")
    looped, losses = eng.create_state(cfg.seed), []
    pretrain(eng, looped, train, valid, cfg, centroids, Log(),
             on_step=lambda i, t, m: losses.append(
                 (t, float(m["total_loss"]))))
    state, mine = eng.create_state(cfg.seed), []
    for i, batch in enumerate(train.batches(2, shuffle=True, seed=cfg.seed,
                                            drop_last=True)):
        task, metrics = pretrain_step(eng, state, batch, centroids, i)
        mine.append((task, float(metrics["total_loss"])))
    assert len(losses) == 6 and mine == losses
    assert [t for t, _ in mine] == [eng.task_for_step(i) for i in range(6)]
    for k, p in looped.model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[k]), k
    assert looped.opt.count == state.opt.count


def test_stage_spans_are_flat_and_counters_count_steps_and_skips():
    eng, state = engine(dropout=0.1)
    centroids = torch.randn(K, FEAT)
    profiling.disable()
    profiling.drain()
    profiling.drain_counts()
    profiling.enable()
    try:
        for i in range(3):
            pretrain_step(eng, state, host_batch(300 + i), centroids, i)
    finally:
        profiling.disable()
    spans = sorted(profiling.drain())
    counts = profiling.drain_counts()
    assert {name for *_, name in spans} == STAGES
    for (s0, e0, _), (s1, _, _) in zip(spans, spans[1:]):
        assert s0 <= e0 <= s1    # none opens inside another
    names = list(state.model.state_dict())
    skipped = sum(len(names) - len(used_param_mask(names, t, eng.cfg))
                  for t in ref.TASKS)
    assert counts == {"xlt.train.steps.vis_mask": 1,
                      "xlt.train.steps.word_mask": 1,
                      "xlt.train.steps.matched": 1,
                      "xlt.train.params_skipped": skipped}
    # off, a span records nothing
    pretrain_step(eng, state, host_batch(303), centroids, 3)
    assert profiling.drain() == [] and profiling.drain_counts() == {}
