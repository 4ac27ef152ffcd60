"""The port's batched-head attention (`ops/attention.mha_hbatch`, plain
version on the CPU) against the JAX kernel it replaces, its launch plan
(`ops/_plan.hbatch_plan`) at every shape the card tests and chip_smoke
give it, and the int8 engine's attention switch against the JAX
engine's.

The JAX kernel is `core_hbatch` in scripts/drive_attention_layout.py,
nested in that script's `main()`, whose module parses argv at import. So
the function is taken out of the source with `ast` and run with jax, jnp
and np in its namespace, in interpret mode on the CPU, as the script
itself would run it there.
"""
import ast
import os
import sys
from collections import Counter

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.lxmert import LxmertModel
from xlxmert_tpu.ops.attention import mha_blhd as jax_mha_blhd
from xlxmert_tpu.serving import lxmert_int8 as jeng
from xlxmert_tpu.utils.boxes import box_position
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops import _plan, attention
from xlxmert_tpu_torch.serving import lxmert_int8 as teng

from test_torch_gpu import HBATCH_SHAPES, near_tie_qkv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (mha_hbatch's path cases)
DRIVER = os.path.join(ROOT, "scripts", "drive_attention_layout.py")
# bf16 outputs: the softmax sum and both products add in other orders,
# and XLA:CPU may keep a fused intermediate in fp32; one bf16 step at
# |out| ~ 2 is 2^-7 * 2 < 2e-2
TOL = 2e-2


def jax_core_hbatch(block: int = 32):
    """`core_hbatch(block)` from the JAX driver's source."""
    with open(DRIVER) as f:
        tree = ast.parse(f.read(), DRIVER)
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "core_hbatch")
    ns = {"jax": jax, "jnp": jnp, "np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), DRIVER, "exec"), ns)
    return ns["core_hbatch"](block)


def operands(seed, B, Lq, Lk, H, D, with_bias):
    """bf16 q/k/v from a numpy seed (numpy arrays of bf16 values) and a
    (B, 1, 1, Lk) bf16 key mask bias, or None."""
    r = np.random.RandomState(seed)

    def bf16(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(
            torch.bfloat16)

    q, k, v = bf16(B, Lq, H * D), bf16(B, Lk, H * D), bf16(B, Lk, H * D)
    bias = None
    if with_bias:
        keep = (r.rand(B, Lk) > 0.3).astype(np.float32)
        keep[:, 0] = 1
        bias = ((1.0 - torch.from_numpy(keep)) * -1e9)[:, None, None, :].to(
            torch.bfloat16)
    return q, k, v, bias


def to_jax(t):
    return None if t is None else jnp.asarray(t.float().numpy(),
                                              jnp.bfloat16)


@pytest.mark.parametrize("Lq,Lk,H,D", [(5, 8, 2, 16), (5, 9, 3, 16),
                                       (8, 9, 4, 16), (8, 8, 2, 64)])
def test_plain_version_matches_the_jax_hbatch_kernel(Lq, Lk, H, D):
    q, k, v, bias = operands(Lq * 10 + Lk, 4, Lq, Lk, H, D, True)
    ref = np.asarray(jax_core_hbatch()(*map(to_jax, (q, k, v, bias)), H),
                     np.float32)
    got = attention.mha_hbatch(q, k, v, bias, H)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("Lq,Lk,H", [(5, 9, 2), (8, 8, 4)])
def test_without_bias_matches_the_jax_blhd_kernel(Lq, Lk, H):
    """The JAX hbatch kernel cannot run without a bias (below); the port
    adds nothing then, which is mha_blhd(fast=True)'s function."""
    q, k, v, _ = operands(Lq + Lk, 4, Lq, Lk, H, 16, False)
    ref = np.asarray(jax_mha_blhd(*map(to_jax, (q, k, v)), None, H,
                                  fast=True), np.float32)
    got = attention.mha_hbatch(q, k, v, None, H)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL, rtol=0)
    # adding a zero bias changes no bit
    zero = torch.zeros(4, 1, 1, Lk, dtype=torch.bfloat16)
    assert torch.equal(attention.mha_hbatch(q, k, v, zero, H), got)


def test_the_jax_hbatch_kernel_raises_without_a_bias():
    """The JAX driver serves without a visual mask, so the visual
    attentions reach `core` with bias=None, where it reshapes None: the
    fault the port does not carry."""
    q, k, v, _ = operands(1, 4, 5, 9, 2, 16, False)
    with pytest.raises(AttributeError, match="reshape"):
        jax_core_hbatch()(*map(to_jax, (q, k, v)), None, 2)


# (B, Lq, Lk, H): chip_smoke's cases at full width and the card tests'
# shapes at 1, 4 and 12 heads, at the layout path's batch and
# calibration's
PLAN_CASES = sorted(
    {(B, lq, lk, 12) for B, lq, lk, _, _ in chip_smoke.hbatch_cases(
        LxmertConfig(), chip_smoke.BATCH)}
    | {(B, lq, lk, H) for B in (256, 8) for lq, lk in HBATCH_SHAPES
       for H in (1, 4, 12)})


@pytest.mark.parametrize("B,Lq,Lk,H", PLAN_CASES)
def test_the_hbatch_plan_covers_every_row_and_head_once(B, Lq, Lk, H):
    """The plan divides H over its groups, its CTAs (the kernel's index
    arithmetic, `hbatch_cta_work`) cover every (batch row, head) exactly
    once, each head of a CTA in its ring slot (head j in slot j % slots,
    more slots than lanes unless every head has one, so that heads land
    while the lanes compute), with one warp a q tile of a lane's head, a
    CTA stays within 227 KB of shared memory, and at B=256 every CTA is
    resident in one wave on 132 SMs, one a batch row."""
    plan = _plan.hbatch_plan(B, H, Lq, Lk)
    (rows, G), heads = plan.grid, plan.heads
    assert rows == B and H % G == 0 and heads == H // G
    cover = Counter()
    for bx in range(rows):
        for by in range(G):
            work = _plan.hbatch_cta_work(plan, bx, by)
            assert len(work["lanes"]) == plan.lanes
            for lane in work["lanes"]:
                assert [h for h, _ in lane] == sorted(h for h, _ in lane)
                assert all(slot == (h - by * heads) % plan.slots
                           for h, slot in lane)
                cover.update((work["row"], h) for h, _ in lane)
    assert cover == Counter({(b, h): 1 for b in range(B) for h in range(H)})
    assert plan.lanes <= heads and plan.slots <= min(heads, 8)
    assert plan.slots > plan.lanes or plan.slots == heads
    # two CTAs an SM: 12 warps up to 32 keys (80 registers a thread), 8
    # beyond (128)
    assert plan.warps == plan.lanes * -(-Lq // 16) <= (12 if Lk <= 32
                                                       else 8)
    # q, k and v of a head (16-row tiles of 64 bf16 + 16 bytes) a slot,
    # an 8-byte barrier a head and the bias row in fp32
    head = (16 * -(-Lq // 16) + 32 * -(-Lk // 16)) * (64 * 2 + 16)
    assert plan.smem == plan.slots * head + 8 * heads + 4 * Lk <= 232_448
    if B == 256:
        assert G == 1
        assert B * G <= 132 * _plan.hbatch_resident(plan, Lk)
    else:
        assert B * G >= 132 or G == H


def test_the_near_tie_case_flips_under_another_order():
    """The card test's near-tie operands (test_torch_gpu.near_tie_qkv):
    their dominant scores round to another bf16 value when summed exactly
    than in the plain version's fp32 chain in many rows, and that moves
    the context by more than the 2e-2 the kernel is held to, so a kernel
    that summed those scores in its own order would fail the test."""
    B, L, H = 2, 64, 12
    q, k, v = near_tie_qkv(np.random.RandomState(6), B, L, H)
    x = q.reshape(B, L, H, 64).astype(np.float64)
    y = k.reshape(B, L, H, 64)[:, :1].astype(np.float64)
    chain = np.zeros((B, L, H), np.float32)
    for d in range(64):   # one fused multiply-add per column
        chain = (x[..., d] * y[..., d] + chain).astype(np.float32)
    scale = np.float32(0.125)

    def bf16(a):
        return torch.from_numpy(np.asarray(a * scale, np.float32)).to(
            torch.bfloat16)

    flips = (bf16(chain) != bf16((x * y).sum(-1))).float().mean().item()
    assert flips > 0.25, flips
    qt, kt, vt = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    plain = attention.mha_hbatch(qt, kt, vt, None, H)
    heads = [attention._heads(t, H).double() for t in (qt, kt, vt)]
    s = (heads[0] @ heads[1].transpose(-1, -2)).float() * float(scale)
    p = attention.softmax_last(s.to(torch.bfloat16)).to(torch.bfloat16)
    exact = (p.float() @ heads[2].float()).to(torch.bfloat16)
    exact = exact.transpose(1, 2).reshape(B, L, H * 64)
    assert (exact.float() - plain.float()).abs().max().item() > 2e-2


SHAPE = dict(vocab_size=200, hidden_size=64, num_attention_heads=4,
             intermediate_size=128, l_layers=2, x_layers=1, r_layers=1,
             visual_feat_dim=32, num_clusters=0)


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def params():
    r = np.random.RandomState(0)
    B, L, V = 4, 8, 16
    ids = r.randint(1, 200, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[1, 5:] = 0
    feats = (r.randn(B, V, 32) * 0.5).astype(np.float32)
    pos = np.broadcast_to(box_position(4)[None], (B, V, 4)).copy()
    model = LxmertModel(JaxConfig(**SHAPE), dtype=jnp.float32)
    p = jax.jit(lambda key: model.init(key, ids, feats, pos,
                                       attention_mask=mask))(
        jax.random.PRNGKey(0))["params"]
    return jax.tree.map(np.asarray, p), (ids, feats, pos, mask)


@pytest.mark.parametrize("impl", ["einsum", "pallas_blhd"])
def test_engine_attention_impl_matches_the_jax_engine(params, impl):
    """The int8 engine (dynamic path) on each attention route against the
    JAX engine on the route of the same name."""
    p, (ids, feats, pos, mask) = params
    jcfg, tcfg = JaxConfig(**SHAPE), LxmertConfig(**SHAPE)
    try:
        jeng.attention_impl(impl)
        ref = jax.jit(lambda qp, *a: jeng.lxmert_forward(
            qp, *a[:3], attention_mask=a[3], n_heads=4))(
            jeng.prepare_params(p, jcfg), ids, feats, pos, mask)
        teng.attention_impl(impl)
        tqp = teng.prepare_params(p, tcfg, device="cpu")
        with torch.inference_mode():
            got = teng.lxmert_forward(
                tqp, *(torch.from_numpy(a) for a in (ids, feats, pos)),
                attention_mask=torch.from_numpy(mask), n_heads=4)
    finally:
        jeng.attention_impl("auto")
        teng.attention_impl("auto")
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == r.shape
        assert cos(g.float().numpy(), np.asarray(r, np.float32)) > 0.999
    with pytest.raises(ValueError, match="attention_impl"):
        teng.attention_impl("hbatch")


def test_engine_routes_reach_the_wrapper_they_name(monkeypatch):
    """"auto" and "pallas_blhd" call mha_blhd (fast), "einsum" does not;
    the core is looked up at call time, so a driver can swap it."""
    calls = []
    monkeypatch.setattr(teng, "mha_blhd", lambda *a, **kw: calls.append(
        kw) or attention.mha_blhd_reference(*a, **kw))
    q, k, v, bias = operands(3, 2, 5, 9, 2, 16, True)
    outs = {}
    try:
        for impl in ("auto", "pallas_blhd", "einsum"):
            teng.attention_impl(impl)
            outs[impl] = teng._attention_core(q, k, v, bias, 2)
    finally:
        teng.attention_impl("auto")
    assert calls == [{"fast": True}] * 2
    assert torch.equal(outs["auto"], outs["pallas_blhd"])
    assert (outs["einsum"].float() - outs["auto"].float()).abs().max() <= TOL
