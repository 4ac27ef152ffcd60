"""Int8 attention in the port (ops/attention_int8.py and the
int8_attention switch of serving/lxmert_int8.py) against the JAX
package's _attention_core_int8 and its engine with int8_attention(True).

Tolerances: the plain version against the JAX function per element
|d| <= v's scale + 2^-7 |ref| (an fp32 exponent or sum order can move
one quantized probability by 1, which moves an output by at most v's
scale, and bf16 rounds the output); serving logits against the JAX
engine's by cosine > 0.99 and argmax agreement >= 0.9
(tests/test_torch_serving.py's bars); the JAX test's three bars
(tests/test_int8_serving.py:251-254) applied to the port."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_serving import (  # noqa: F401  (fixtures)
    JCFG, N_ANS, TCFG, batch, calibrated, cos, params, to_torch,
)
from xlxmert_tpu.models.lxmert import LxmertModel, VisualAnswerHead
from xlxmert_tpu.ops.quant import make_act_scale as jax_make_act_scale
from xlxmert_tpu.ops.quant import with_act_scale as jax_with_act_scale
from xlxmert_tpu.serving import lxmert_int8 as jeng
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops import attention_int8
from xlxmert_tpu_torch.ops.quant import (
    ActScale, make_act_scale, with_act_scale,
)
from xlxmert_tpu_torch.serving import lxmert_int8 as teng


@pytest.mark.parametrize("D,H,masked", [(8, 4, True), (8, 4, False),
                                        (64, 2, True), (64, 3, False)])
def test_plain_version_matches_jax_attention_core_int8(D, H, masked):
    r = np.random.RandomState(D * 10 + H)
    B, Lq, Lk = 3, 12, 20
    q, k, v = (r.randn(B, L, H * D).astype(np.float32) * s
               for L, s in ((Lq, 1.0), (Lk, 1.5), (Lk, 0.7)))
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    bias = None
    if masked:
        keep = r.rand(B, Lk) > 0.3
        keep[:, 0] = True
        bias = ((1.0 - keep.astype(np.float32)) * -1e9)[:, None, None, :]
    amax = [float(jnp.abs(x.astype(jnp.float32)).max()) for x in (qb, kb, vb)]
    jact = {n: jax_with_act_scale(jax_make_act_scale(), a)
            for n, a in zip("qkv", amax)}
    sites = [with_act_scale(make_act_scale(), a) for a in amax]
    # the scales are the JAX package's float32 values
    assert [s.inv for s in sites] == [float(jact[n].inv) for n in "qkv"]
    assert [s.scale for s in sites] == [float(jact[n].scale) for n in "qkv"]
    ref = np.asarray(jeng._attention_core_int8(
        qb, kb, vb, None if bias is None else jnp.asarray(bias).astype(
            jnp.bfloat16), H, jact).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    tb = None if bias is None else torch.from_numpy(bias).to(torch.bfloat16)
    got = attention_int8.mha_int8(tq, tk, tv, tb, H,
                                  [s.inv for s in sites],
                                  [s.scale for s in sites])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    d = np.abs(got.float().numpy() - ref)
    assert (d <= sites[2].scale + 2.0 ** -7 * np.abs(ref)).all(), d.max()


def test_int8_attention_serving_logits_match_the_jax_engine(calibrated):
    _, _, jqp, jhp, jcal, tqp, thp, _ = calibrated
    sqp = jeng.apply_calibration(jqp, jcal)
    shqp = jeng.apply_calibration(jhp, jcal)
    ids, feats, pos, mask = batch(99, 32)  # held out of calibration
    jeng.int8_attention(True)
    try:
        ref = np.asarray(jeng.make_vqa_serving_fn(JCFG)(
            sqp, shqp, ids, feats, pos, mask))
    finally:
        jeng.int8_attention(False)
    got = port_logits(tqp, thp, (ids, feats, pos, mask), True)
    assert got.shape == ref.shape == (32, N_ANS)
    assert cos(got, ref) > 0.99
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


def port_logits(tqp, thp, b, int8_att):
    ti, tf, tp, tm = to_torch(b)
    teng.int8_attention(int8_att)
    try:
        with torch.inference_mode():
            return teng.vqa_forward(tqp, thp, ti, tf, tp, attention_mask=tm,
                                    n_heads=4).numpy()
    finally:
        teng.int8_attention(False)


def test_the_jax_tests_three_bars_hold_for_the_port(params, calibrated):
    """tests/test_int8_serving.py::test_int8_attention_einsums_match_bf16
    _attention's bars: int8 against bf16 attention on the same calibrated
    tree by cosine > 0.99 and argmax >= 0.8, and against the fp32 flax
    model by cosine > 0.97."""
    p, hp = params
    tqp, thp = calibrated[5], calibrated[6]
    b = batch(99, 32)
    base = port_logits(tqp, thp, b, False)
    got = port_logits(tqp, thp, b, True)
    model = LxmertModel(JCFG, dtype=jnp.float32)
    head = VisualAnswerHead(JCFG, num_labels=N_ANS, dtype=jnp.float32)
    _, _, pooled = model.apply({"params": p}, *b[:3], attention_mask=b[3],
                               deterministic=True)
    ref = np.asarray(head.apply({"params": hp}, pooled))
    assert cos(got, base) > 0.99, cos(got, base)
    assert cos(got, ref) > 0.97, cos(got, ref)
    assert (got.argmax(-1) == base.argmax(-1)).mean() >= 0.8


def test_switch_on_with_an_uncalibrated_tree_raises(params, calibrated):
    p, hp = params
    tqp = teng.prepare_params(p, TCFG, device="cpu")
    thp = teng.prepare_answer_head(hp, device="cpu")
    with pytest.raises(RuntimeError, match="calibrated"):
        port_logits(tqp, thp, batch(3, 4), True)
    assert not teng._INT8_ATTENTION
    # the calibrated tree serves with it
    got = port_logits(calibrated[5], calibrated[6], batch(3, 4), True)
    assert np.isfinite(got).all()


def test_an_int8_sampler_step_runs_through_the_plain_version(monkeypatch):
    """With the switch on, every attention of an int8 sampler decode step
    is mha_int8 (its plain version on the CPU) and none is mha_blhd."""
    from xlxmert_tpu_torch.serving import sampling_int8 as tsi
    from xlxmert_tpu_torch.tasks import sampling

    cfg = LxmertConfig(vocab_size=89, hidden_size=32, num_attention_heads=4,
                       intermediate_size=64, l_layers=2, x_layers=1,
                       r_layers=1, visual_feat_dim=16, num_clusters=23)
    grid, B, T = 3, 2, 6
    params = sampling.random_params(cfg, seed=0)
    centroids = np.random.RandomState(0).randn(23, 16).astype(np.float32)
    sp = tsi.prepare_sampler_params(params, cfg, centroids, "cpu")
    ids = torch.randint(1, 89, (B, T), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones(B, T)
    tsi.calibrate_sampler(sp, torch.from_numpy(centroids), ids, mask, cfg,
                          grid)
    teng.apply_calibration(sp)
    sites = [m for _, m in teng.calibration_sites(sp)
             if isinstance(m, ActScale)]
    assert sites and all(s.calibrated for s in sites)
    calls = {"mha_int8_reference": 0, "mha_blhd": 0}
    plain, blhd = attention_int8.mha_int8_reference, teng.mha_blhd

    def count(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(attention_int8, "mha_int8_reference",
                        count("mha_int8_reference", plain))
    monkeypatch.setattr(teng, "mha_blhd", count("mha_blhd", blhd))
    feats = torch.from_numpy(centroids[:grid * grid][None].repeat(B, 0)).to(
        torch.bfloat16)
    pos = sampling.grid_positions(grid, B, "cpu", torch.bfloat16)
    teng.int8_attention(True)
    try:
        with torch.inference_mode():
            logits = tsi._predict_forward(sp, ids, feats, pos, mask, 4)
    finally:
        teng.int8_attention(False)
    assert logits.shape == (B, grid * grid, 23) and torch.isfinite(
        logits).all()
    # 2 language and 1 visual self-attention; the one (last) cross layer
    # computes only its visual side: the cross attention and the visual
    # self-attention
    assert calls == {"mha_int8_reference": 2 + 1 + 2, "mha_blhd": 0}
