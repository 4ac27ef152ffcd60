"""Port's whole-block fused int8 chain (ops/fused_block.py, plain version
on the CPU) and fused engine (serving/lxmert_fused.py) against the JAX
package's `fused_block` (Pallas, interpret mode on the CPU) and
`lxmert_forward_fused`, on the same numpy weights and activation scales;
and against the port's own static int8 engine, bit for bit."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from test_torch_serving import jax_sites
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.ops import fused_block as jfb
from xlxmert_tpu.ops import quant as jquant
from xlxmert_tpu.serving import lxmert_fused as jfused
from xlxmert_tpu.serving import lxmert_int8 as jeng
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops import fused_block as tfb
from xlxmert_tpu_torch.ops import quant as tquant
from xlxmert_tpu_torch.serving import lxmert_fused as tfused
from xlxmert_tpu_torch.serving import lxmert_int8 as teng

# the CFG of tests/test_fused_block.py
SHAPE = dict(vocab_size=97, hidden_size=32, num_attention_heads=4,
             intermediate_size=64, l_layers=2, x_layers=2, r_layers=1,
             visual_feat_dim=16)
JCFG, TCFG = JaxConfig(**SHAPE), LxmertConfig(**SHAPE)
H, I = 32, 64


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)


def close(got, ref, cosine, atol, name):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    assert cos(got, ref) > cosine, (name, cos(got, ref))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=name)


def weights(rng, k, n, amax):
    """The same calibrated int8 weight on both sides."""
    w = rng.randn(k, n).astype(np.float32) * 0.2
    b = rng.randn(n).astype(np.float32) * 0.05
    return (jquant.with_activation_scale(jquant.quantize_weight(w, b), amax),
            tquant.with_activation_scale(tquant.quantize_weight(w, b), amax))


def block_inputs(seed, lead):
    rng = np.random.RandomState(seed)
    out, w1, w2, tail = (weights(rng, H, H, 3.0), weights(rng, H, I, 2.0),
                         weights(rng, I, H, 4.0),
                         weights(rng, H, 3 * H, 2.5))
    lns = [(rng.rand(H).astype(np.float32) + 0.5,
            rng.randn(H).astype(np.float32) * 0.1) for _ in range(2)]
    ctx, x = (rng.randn(*lead, H).astype(np.float32) for _ in range(2))
    return out, w1, w2, tail, lns, ctx, x


@pytest.mark.parametrize("has_ffn,has_tail", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_fused_block_matches_jax_kernel(has_ffn, has_tail):
    """Ragged rows (M = 15), the reference's bar: cosine > 0.9999, atol
    1e-1 (its LayerNorm sums run in another order)."""
    out, w1, w2, tail, lns, ctx, x = block_inputs(0, (3, 5))
    (g1, b1), (g2, b2) = lns
    jw = lambda p: jfb.fused_weight(p[0])  # noqa: E731
    ref = jfb.fused_block(
        jnp.asarray(ctx).astype(jnp.bfloat16),
        jnp.asarray(x).astype(jnp.bfloat16), jw(out), jnp.asarray(g1),
        jnp.asarray(b1), *((jw(w1), jw(w2), jnp.asarray(g2),
                            jnp.asarray(b2)) if has_ffn else (None,) * 4),
        tail_w=jw(tail) if has_tail else None, has_ffn=has_ffn)

    tw = lambda p: tfb.fused_weight(p[1])  # noqa: E731
    tctx, tx = (torch.from_numpy(a).to(torch.bfloat16) for a in (ctx, x))
    ln1, ln2 = (tfb.LN(torch.from_numpy(g), torch.from_numpy(b))
                for g, b in lns)
    got = tfb.fused_block_reference(
        tctx, tx, tw(out), ln1,
        *((tw(w1), tw(w2), ln2) if has_ffn else (None,) * 3),
        tw(tail) if has_tail else None)
    wrapped = tfb.fused_block(
        tctx, tx, tw(out), ln1.scale, ln1.bias,
        *((tw(w1), tw(w2), ln2.scale, ln2.bias) if has_ffn
          else (None,) * 4),
        tail_w=tw(tail) if has_tail else None, has_ffn=has_ffn)
    if not has_tail:
        got, wrapped, ref = (got,), (wrapped,), (ref,)
    assert len(got) == len(ref) == 1 + has_tail
    for g, w, r, name in zip(got, wrapped, ref, ("y", "tail")):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
        close(g, r, 0.9999, 1e-1, name)


def test_fused_block_reference_is_the_static_engine_chain_bit_for_bit():
    """The engine's modules (QuantWeight static forward, LayerNorm, tanh
    gelu) on the same inputs give the plain version's bits."""
    out, w1, w2, tail, lns, ctx, x = block_inputs(1, (2, 7))
    ln1, ln2 = (teng.LayerNorm({"scale": g, "bias": b}) for g, b in lns)
    tctx, tx = (torch.from_numpy(a).to(torch.bfloat16) for a in (ctx, x))
    with torch.inference_mode():
        y1 = ln1(out[1](tctx) + tx)
        y2 = ln2(w2[1](F.gelu(w1[1](y1), approximate="tanh")) + y1)
        q = tail[1](y2)
        fw = {k: tfb.fused_weight(p[1]) for k, p in
              (("out", out), ("w1", w1), ("w2", w2), ("tail", tail))}
        got_y, got_q = tfb.fused_block_reference(
            tctx, tx, fw["out"], ln1, fw["w1"], fw["w2"], ln2, fw["tail"])
        got_y1 = tfb.fused_block_reference(tctx, tx, fw["out"], ln1)
    assert torch.equal(got_y, y2) and torch.equal(got_q, q)
    assert torch.equal(got_y1, y1)


def test_concat_fused_and_fused_weight():
    rng = np.random.RandomState(2)
    (_, q), (_, kv) = weights(rng, H, H, 2.0), weights(rng, H, 2 * H, 2.0)
    cat = tfb.concat_fused(q, kv)
    assert tuple(cat.w_i8.shape) == (3 * H, H)
    assert tuple(cat.out_scale.shape) == tuple(cat.bias.shape) == (1, 3 * H)
    x = torch.from_numpy(rng.randn(4, H).astype(np.float32)).to(
        torch.bfloat16)
    both = tfb.plain_dense(x, cat)
    assert torch.equal(both[:, :H], q(x)) and torch.equal(both[:, H:], kv(x))
    _, other = weights(rng, H, 2 * H, 2.5)
    with pytest.raises(ValueError, match="input scales differ"):
        tfb.concat_fused(q, other)
    raw = tquant.quantize_weight(rng.randn(H, H).astype(np.float32))
    with pytest.raises(ValueError, match="not calibrated"):
        tfb.fused_weight(raw)


@pytest.fixture(scope="module")
def calibrated():
    """The same flax-layout parameters and the JAX engine's calibrated
    amax per site, given to both engines by site name."""
    bert, head = teng.random_params(TCFG, 7, seed=3)
    r = np.random.RandomState(4)
    B, L, V = 4, 8, 9
    ids = r.randint(1, 97, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[1, 5:] = 0
    feats = (r.randn(B, V, 16) * 0.5).astype(np.float32)
    pos = r.rand(B, V, 4).astype(np.float32)
    batch = (ids, feats, pos, mask)
    jqp, jhp = jeng.prepare_params(bert, JCFG), jeng.prepare_answer_head(head)
    jcal = jeng.calibrate(jqp, jhp, [batch], JCFG)
    names = {**jax_sites(jqp, "0"), **jax_sites(jhp, "1")}
    tqp = teng.prepare_params(bert, TCFG, device="cpu")
    thp = teng.prepare_answer_head(head, device="cpu")
    sites = dict(teng.calibration_sites(tqp, thp))
    assert len(jcal) == len(sites)
    for key, amax in jcal.items():
        sites[names[key]].amax = amax
    teng.apply_calibration(tqp, thp)
    teng.assert_fully_calibrated(tqp, thp)
    return jeng.apply_calibration(jqp, jcal), tqp, batch


def test_fused_forward_matches_jax_and_the_static_engine(calibrated):
    """The reference's fused-vs-static bar against the JAX fused forward
    (accelerator attention route, interpret mode): cosine > 0.999, atol
    5e-2; the port's own static engine: the same bits."""
    sqp, tqp, batch = calibrated
    try:
        jeng.attention_impl("pallas_blhd")
        ref = jfused.lxmert_forward_fused(
            jfused.prepare_fused(sqp, JCFG), *batch[:3],
            attention_mask=batch[3], n_heads=4)
    finally:
        jeng.attention_impl("auto")
    fp = tfused.prepare_fused(tqp, TCFG)
    ids, feats, pos, mask = (torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        got = tfused.lxmert_forward_fused(fp, ids.long(), feats, pos,
                                          attention_mask=mask, n_heads=4)
        static = teng.lxmert_forward(tqp, ids.long(), feats, pos,
                                     attention_mask=mask, n_heads=4)
    for g, r, s, name in zip(got, ref, static, ("lang", "visn", "pooled")):
        assert g.dtype == torch.bfloat16
        close(g, r, 0.999, 5e-2, name)
        assert torch.equal(g, s), name
    # 2 + 1 stack blocks, 2 x-layers of 2 cross and 2 self blocks
    assert len(fp.lang) == 2 and len(fp.visn) == 1 and len(fp.x) == 2
    assert fp.lang[-1].tail is fp.visn[-1].tail
    assert fp.x[0].lang_self.tail is fp.x[0].visn_self.tail
    assert fp.x[-1].lang_self.tail is None
