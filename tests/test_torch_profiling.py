"""utils/profiling: the stage spans (off: nothing recorded, nothing
allocated; on: flat (start, end, name) on time.time_ns, drained) and the
counters beside them (the same rule), the stages the int8 and fused
serving forwards, the int8 NAR sampler and the render record, their
outputs with tracing on and off, the NAR sampler's CPU call (eager: no
graph, no counter, the loop's values), the calibration version, and the
ranges `trace()` opens for the spans. CPU, tiny configurations."""
import time

import numpy as np
import pytest
import torch

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.utils import profiling

SHAPE = dict(vocab_size=40, hidden_size=32, num_attention_heads=4,
             intermediate_size=64, l_layers=2, x_layers=2, r_layers=1,
             visual_feat_dim=16, num_clusters=23)
CFG = LxmertConfig(**SHAPE)
GRID, B, L = 3, 4, 6
SERVE = ["xlt.serve.inputs", "xlt.engine.language", "xlt.engine.visual",
         "xlt.engine.cross", "xlt.serve.head"]
STEP = ["xlt.sampler.remask", "xlt.sampler.visual", "xlt.sampler.cross",
        "xlt.sampler.head", "xlt.sampler.commit"]


@pytest.fixture(autouse=True)
def tracer_left_off():
    """Every test starts and ends with the tracer off and empty."""
    profiling.disable()
    profiling.drain()
    profiling.drain_counts()
    yield
    profiling.disable()
    profiling.drain()
    profiling.drain_counts()


def recorded(fn, *args):
    """fn(*args) with the tracer on: (its result, the span names)."""
    profiling.enable()
    try:
        out = fn(*args)
    finally:
        profiling.disable()
    return out, [name for _, _, name in profiling.drain()]


def test_off_records_nothing_and_the_body_keeps_its_value():
    def body():
        with profiling.span("xlt.test"):
            return 41 + 1

    assert profiling.span("a") is profiling.span("b")   # one null context
    assert body() == 42
    assert profiling.drain() == []


def test_on_records_flat_time_ordered_spans_and_drain_empties():
    profiling.enable()
    t0 = time.time_ns()
    for name in ("a", "b", "c"):
        with profiling.span(name):
            pass
    t1 = time.time_ns()
    profiling.disable()
    with profiling.span("after"):
        pass
    spans = profiling.drain()
    assert [n for *_, n in spans] == ["a", "b", "c"]
    assert spans[0][0] >= t0 and spans[-1][1] <= t1
    for (s, e, _), (s2, _, _) in zip(spans, spans[1:]):
        assert s <= e <= s2     # flat: each closes before the next opens
    assert profiling.drain() == []


def test_counters_count_only_while_recording_and_drain_empties():
    profiling.count("xlt.test.off")
    assert profiling.counts() == {} and not profiling.recording()
    profiling.enable()
    assert profiling.recording()
    profiling.count("xlt.test.a")
    profiling.count("xlt.test.a", 2)
    profiling.count("xlt.test.b")
    profiling.disable()
    profiling.count("xlt.test.a")       # off again: not counted
    want = {"xlt.test.a": 3, "xlt.test.b": 1}
    assert profiling.counts() == want
    profiling.counts()["xlt.test.a"] = 0    # a copy
    assert profiling.drain_counts() == want
    assert profiling.counts() == {} and profiling.drain() == []


@pytest.fixture(scope="module")
def served():
    """A calibrated int8 engine on the CPU, its fused tree, a catalog and
    two batches of host inputs."""
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.serving.lxmert_fused import prepare_fused
    from xlxmert_tpu_torch.utils.boxes import box_position

    bert, head = engine.random_params(CFG, 5, seed=3)
    qp = engine.prepare_params(bert, CFG, "cpu")
    hqp = engine.prepare_answer_head(head, "cpu")
    g = torch.Generator().manual_seed(0)
    V = GRID * GRID
    table = torch.randn(6, V, SHAPE["visual_feat_dim"], generator=g).to(
        torch.bfloat16)
    cache = FeatureCache(table, {str(i): i for i in range(6)})
    batches = []
    for k in range(2):
        ids = torch.randint(1, SHAPE["vocab_size"], (B, L), generator=g)
        ids[k, L - 2:] = 0
        batches.append((ids, torch.randint(0, 6, (B,), generator=g),
                        (ids > 0).float()))
    pos = torch.from_numpy(box_position(GRID)).to(torch.bfloat16)
    engine.calibrate(qp, hqp, [(ids, cache.table[picks].float(),
                                pos[None].expand(B, V, 4), mask)
                               for ids, picks, mask in batches], CFG)
    engine.apply_calibration(qp, hqp)
    return qp, hqp, prepare_fused(qp, CFG), cache, batches


@pytest.mark.parametrize("fused", [False, True], ids=["int8", "fused"])
def test_serving_forwards_record_their_stages_and_keep_their_answers(
        served, fused):
    from xlxmert_tpu_torch.cli import serve

    qp, hqp, fp, cache, batches = served
    run = (serve.fused_serving_forward(fp, hqp, cache, CFG, "cpu") if fused
           else serve.serving_forward(qp, hqp, cache, CFG, "cpu"))
    plain = [run(*b) for b in batches]
    assert profiling.drain() == []
    traced, names = recorded(lambda: [run(*b) for b in batches])
    assert names == SERVE * len(batches)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def sampler():
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.tasks.sampling import random_params

    params = random_params(CFG, seed=4)
    centroids = np.random.RandomState(1).randn(
        SHAPE["num_clusters"], SHAPE["visual_feat_dim"]).astype(np.float32)
    sp = si.prepare_sampler_params(params, CFG, centroids, "cpu")
    ids = torch.randint(1, SHAPE["vocab_size"], (B, L),
                        generator=torch.Generator().manual_seed(2))
    table = torch.from_numpy(centroids)
    si.calibrate_sampler(sp, table, ids, (ids > 0).float(), CFG, GRID)
    engine.apply_calibration(sp)
    return sp, table, ids


def test_nar_sampler_records_its_language_stage_and_five_a_step(sampler):
    from xlxmert_tpu_torch.serving import sampling_int8 as si

    sp, table, ids = sampler
    hooked = []
    sample = si.make_nar_sampler_int8(
        CFG, 2, GRID, on_step=lambda i, *_: hooked.append(i))
    plain = sample(sp, table, ids, (ids > 0).float())
    traced, names = recorded(sample, sp, table, ids, (ids > 0).float())
    assert names == ["xlt.sampler.language"] + STEP * 2
    assert hooked == [0, 1, 0, 1]
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_nar_sampler_on_the_cpu_runs_its_loop_eagerly(sampler):
    """No graph off the card: no replay span, both counters at 0, and
    the values of the decode loop written out from the sampler's parts
    (language stack, re-mask, prediction, commit), bit for bit."""
    import torch.nn.functional as F

    from xlxmert_tpu_torch.serving import sampling_int8 as si

    sp, table, ids = sampler
    mask = (ids > 0).float()
    n_steps, n_cells, n_heads = 3, GRID * GRID, CFG.num_attention_heads
    hooked = []
    sample = si.make_nar_sampler_int8(
        CFG, n_steps, GRID, on_step=lambda i, inp, lg: hooked.append(
            (inp["feats"], inp["vis_mask"], lg)))
    got, names = recorded(sample, sp, table, ids, mask)
    assert profiling.counts() == {}
    assert names == ["xlt.sampler.language"] + STEP * n_steps
    with torch.inference_mode():
        cb, pos, code, cids, lang, lang_bias = si._start(
            sp, table, ids, mask, n_cells, GRID, n_heads)
        prob = torch.zeros(cids.shape)
        for i in range(n_steps):
            vis_mask = si.remask_by_rank(
                prob, ((n_steps - i) * n_cells) // n_steps)
            feats = torch.where(vis_mask[..., None],
                                sp.mask_feat[None, None, :], code)
            logits = si._predict_from_lang(sp, lang, lang_bias, feats, pos,
                                           n_heads)
            for a, b in zip(hooked[i], (feats, vis_mask, logits)):
                assert torch.equal(a, b)
            prob, pred_id = si._log_prob_max(logits)
            code = torch.where(vis_mask[..., None],
                               F.embedding(pred_id, cb), code)
            cids = torch.where(vis_mask, pred_id, cids)
    for a, b in zip(got, (code, cids, prob)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_apply_calibration_bumps_the_calibration_version(sampler):
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine

    sp = sampler[0]
    v = engine.calibration_version()
    engine.apply_calibration(sp)        # the same amax: the same scales
    assert engine.calibration_version() == v + 1
    engine.apply_calibration()
    assert engine.calibration_version() == v + 2


def test_render_records_its_span():
    from xlxmert_tpu_torch.models import gan

    gen = gan.Generator(emb_dim=16, base_dim=8, target_size=12,
                        init_H=GRID, init_W=GRID, codebook_dim=8)
    v = gan.random_variables(16, 8, 12, GRID, 8, seed=1)
    gan.load_variables(gen, v["params"], v["sn"])
    code = torch.randn(2, GRID * GRID, 16,
                       generator=torch.Generator().manual_seed(3))
    plain = gan.render(gen, code)
    traced, names = recorded(gan.render, gen, code)
    assert names == ["xlt.render"] and torch.equal(plain, traced)


def test_trace_opens_a_record_function_for_each_span(tmp_path):
    x = torch.ones(8, 8)
    with profiling.span("xlt.before"):      # outside trace(): no range
        x = x @ x
    with profiling.trace() as prof:
        with profiling.span("xlt.one"):
            x = x @ x
        with profiling.span("xlt.two"):
            x = x + 1
    names = {e.name for e in prof.events()}
    assert {"xlt.one", "xlt.two"} <= names and "xlt.before" not in names
    assert profiling.drain() == []          # ranges alone record nothing
    with profiling.trace(str(tmp_path)):
        with profiling.span("xlt.written"):
            x = x * 2
    (path,) = tmp_path.glob("*.pt.trace.json")
    assert '"xlt.written"' in path.read_text()
    with profiling.span("xlt.after"):       # trace() left the flag off
        pass
    assert profiling.span("a") is profiling.span("b")
