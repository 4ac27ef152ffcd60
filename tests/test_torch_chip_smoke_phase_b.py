"""chip_smoke.py's kernel phase (b) on the CPU: how it times the
attention kernels (queued and back to back) and its fused_mha gradient
check, at a small width with the card's work done on CPU tensors. Apart
from tests/test_torch_chip_smoke.py, whose path phases take long, so
that the two files run on separate workers."""
import math
import os
import sys
from collections import Counter

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401
from xlxmert_tpu_torch.core.config import LxmertConfig  # noqa: E402
from xlxmert_tpu_torch.serving import lxmert_int8 as engine  # noqa: E402

SMALL = dict(vocab_size=4100, hidden_size=128, num_attention_heads=2,
             intermediate_size=96, l_layers=2, x_layers=1, r_layers=1,
             visual_feat_dim=16, num_clusters=50)

pytestmark = pytest.mark.usefixtures("share_the_cores")


class _CpuTorch:
    """torch with a no-op torch.cuda.synchronize, to run a kernel-phase
    check on CPU tensors."""

    class cuda:
        @staticmethod
        def synchronize():
            pass

    def __getattr__(self, name):
        return getattr(torch, name)


def test_attention_phase_times_the_card_with_its_queue_kept_full(
        monkeypatch):
    """Phase (b)'s mha_blhd and fused_mha rows: the kernel, its plain
    version and SDPA timed by queued_ms (the card's queue kept full, the
    median of QUEUED_RUNS runs); the kernel and SDPA also back to back by time_ms, as enqueue_ms and
    library_enqueue_ms; per_forward sums each over a forward's launches.
    Run on the CPU at a small width with the timers replaced."""
    import torch.nn.functional as F

    from xlxmert_tpu_torch.ops import attention

    cfg = LxmertConfig(**SMALL)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    timed = Counter()

    def fake_queued(torch_, fn):
        fn()
        timed["queued"] += 1
        return 1.0, True

    def fake_time(torch_, fn):
        fn()
        timed["back to back"] += 1
        return 2.0

    def qkv_bias(torch_, rng, B, lq, lk, HD, dtype, with_bias):
        g = torch.Generator().manual_seed(B * 1000 + lq * 10 + lk)
        qkv = torch.randn(B, lq, 3 * HD, generator=g).to(dtype)
        kv = torch.randn(B, lk, 2 * HD, generator=g).to(dtype)
        bias = None
        if with_bias:
            bias = torch.zeros(B, lk, dtype=torch.bfloat16)
            bias[0, lk // 2:] = -1e9
        return qkv[..., :HD], kv[..., :HD], kv[..., HD:], bias

    monkeypatch.setattr(chip_smoke, "queued_ms", fake_queued)
    monkeypatch.setattr(chip_smoke, "time_ms", fake_time)
    monkeypatch.setattr(chip_smoke, "_qkv_bias", qkv_bias)
    for name in ("mha_blhd", "fused_mha"):
        timed.clear()
        rows = chip_smoke.check_attention(_CpuTorch(), F, attention, cfg,
                                          None, lambda m: None, name=name)
        assert rows and timed == {
            "queued": 3 * chip_smoke.QUEUED_RUNS * len(rows),
            "back to back": 2 * len(rows)}
        for r in rows:
            assert (r["ms"], r["plain_ms"], r["library_ms"]) == (1, 1, 1)
            assert r["enqueue_ms"] == r["library_enqueue_ms"] == 2
            assert r["not_queued"] == [] and r["max_abs_err"] == 0
        per = chip_smoke.per_forward(rows, engine.VQA_LENGTH_MIX,
                                     chip_smoke.KINDS[name])
        for kind in chip_smoke.KINDS[name]:
            n = sum(r["uses"].get(kind, 0) for r in rows)
            assert n == cfg.l_layers + cfg.r_layers + 4 * cfg.x_layers
            assert per[kind]["ms"] == per[kind]["library_ms"] == n
            assert per[kind]["enqueue_ms"] == 2 * n
            assert per[kind]["library_enqueue_ms"] == 2 * n
        assert math.isclose(per["mix"]["enqueue_ms"],
                            2 * per["mix"]["ms"])


def test_fused_mha_gradient_check_runs_on_the_cpu():
    """Phase (b)'s C1 check at a small width with the "card" on the CPU:
    fused_mha's gradients (its autograd Function) agree with the einsum's
    in every case, and the three forward-only kernels refuse a
    backward."""
    from xlxmert_tpu_torch.ops import attention, ffn

    cfg = LxmertConfig(**SMALL)
    log = []
    rows = chip_smoke.check_fused_mha_grad(
        torch, attention, ffn, cfg, torch.Generator().manual_seed(0),
        log.append, device="cpu")
    assert len(rows) == 6
    assert {(r["Lq"], r["Lk"]) for r in rows} == {
        (chip_smoke.FT_TEXT, 64), (64, chip_smoke.FT_TEXT)}
    for r in rows:
        assert set(r["max_abs_err"]) == {"out", "q", "k", "v", "bias"}
        # the same einsum backward on both sides here
        assert all(r["max_abs_err"][n] == 0 for n in "qkv")
        # the fp32 case's bf16 bias gradient: one bf16 step of its largest
        assert ("bias_bar" in r) == (r["dtype"] == "float32")
    assert sum("the backward raises" in m for m in log) == 3
    assert [chip_smoke.bf16_step(x) for x in (1.0, 3.0, 0.015, 0.0)] == [
        2.0 ** -7, 2.0 ** -6, 2.0 ** -14, 0.0]
    # the fp32 case's bias bar is per element, 2^-7 |r| + t: it catches a
    # small element moved by 5 %, which the absolute bar before it (one
    # bf16 step of the largest |r|) let pass
    for r in rows:
        if r["dtype"] == "float32":
            assert r["bias_bar"]["excess"] <= 0
    H, D = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, H, L, D, generator=g)
               for L in (chip_smoke.FT_TEXT, 64, 64))
    bias = (0.5 * torch.randn(2, 64, generator=g)).to(torch.bfloat16)
    grad = torch.randn(2, H, chip_smoke.FT_TEXT, D, generator=g)
    leaf = bias.clone().requires_grad_()
    attention.einsum_mha_reference(q, k, v, leaf, False).backward(grad)
    ref = leaf.grad.float()
    t = chip_smoke.bias_grad_sum_bound(torch, q, k, v, bias, grad)
    assert chip_smoke.bias_grad_excess(ref, ref, t) <= 0
    old_bar = chip_smoke.bf16_step(ref.abs().max().item())
    small = (0.05 * ref.abs() <= old_bar) & (
        0.04 * ref.abs() > chip_smoke.BIAS_GRAD_REL * ref.abs() + t)
    i = int(torch.nonzero(small.ravel())[0])
    moved = ref.clone().ravel()
    moved[i] = (moved[i] * 1.05).to(torch.bfloat16).float()
    moved = moved.reshape(ref.shape)
    assert (moved - ref).abs().max() <= old_bar
    assert chip_smoke.bias_grad_excess(moved, ref, t) > 0


def test_int8_phase_times_the_card_with_its_queue_kept_full(monkeypatch):
    """Phase (b)'s int8_dense rows: the kernel, its plain version and
    torch._int_mm (where it takes the shape: not the answer head) timed
    by queued_ms, the median of QUEUED_RUNS runs; the kernel also back
    to back by time_ms (enqueue_ms). per_forward sums each over a
    forward's launches, int_mm_ms (and the kernel's time beside it) over
    the shapes _int_mm takes. Run on the CPU at a small width with the
    timers replaced and _int_mm computed by the plain int32 product."""
    from xlxmert_tpu_torch.ops import int8_matmul, quant

    cfg = LxmertConfig(**SMALL)
    timed = Counter()

    def fake_queued(torch_, fn):
        fn()
        timed["queued"] += 1
        return 1.0, True

    def fake_time(torch_, fn):
        fn()
        timed["back to back"] += 1
        return 2.0

    class _Torch(_CpuTorch):
        @staticmethod
        def _int_mm(a, b):
            return quant.int8_accumulate(a, b.t())

    monkeypatch.setattr(chip_smoke, "queued_ms", fake_queued)
    monkeypatch.setattr(chip_smoke, "time_ms", fake_time)
    rows = chip_smoke.check_int8(_Torch(), int8_matmul, quant, cfg, 4, 3129,
                                 torch.Generator().manual_seed(0),
                                 lambda m: None, device="cpu")
    with_mm = [r for r in rows if r["int_mm_ms"] is not None]
    assert with_mm and len(with_mm) < len(rows)
    assert all(r["N"] in (3129, 2) or r["M"] <= 16 for r in rows
               if r["int_mm_ms"] is None)
    assert timed == {
        "queued": chip_smoke.QUEUED_RUNS * (2 * len(rows) + len(with_mm)),
        "back to back": len(rows)}
    for r in rows:
        assert (r["ms"], r["plain_ms"], r["enqueue_ms"]) == (1, 1, 2)
        assert r["int_mm_ms"] in (None, 1)
        assert r["max_abs_err"] == 0 and r["not_queued"] == []
        assert r["library_ms"] is None
    per = chip_smoke.per_forward(rows, engine.VQA_LENGTH_MIX,
                                 chip_smoke.KINDS["int8_dense"])
    serving = 4 * (cfg.l_layers + cfg.r_layers) + 14 * cfg.x_layers + 3
    for L in chip_smoke.BUCKETS:
        t = per[f"L={L}"]
        assert t["ms"] == t["plain_ms"] == serving
        assert t["enqueue_ms"] == 2 * serving
        # every launch but the head's two (M = B = 4 rows) is _int_mm's
        assert t["int_mm_ms"] == t["int_mm_kernel_ms"] == serving - 2
    assert per["calib"]["ms"] == serving
    assert math.isclose(per["mix"]["int_mm_ms"], serving - 2)
    assert math.isclose(per["mix"]["enqueue_ms"], 2 * per["mix"]["ms"])


def test_fused_phases_time_the_card_with_their_queue_kept_full(monkeypatch):
    """Phase (b)'s fused_ffn and fused_block rows: the kernel, its plain
    version and its library chain (fused_block: also the chain composed
    through the int8 dense kernel) timed by queued_ms, the median of
    QUEUED_RUNS runs; the kernel also back to back by time_ms
    (enqueue_ms); per_forward sums each over a forward's launches. Run on
    the CPU at a small width with the timers replaced and _int_mm
    computed by the plain int32 product."""
    import torch.nn.functional as F

    from xlxmert_tpu_torch.ops import ffn, fused_block, int8_matmul, quant

    cfg = LxmertConfig(**SMALL)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    timed = Counter()

    def fake_queued(torch_, fn):
        fn()
        timed["queued"] += 1
        return 1.0, True

    def fake_time(torch_, fn):
        fn()
        timed["back to back"] += 1
        return 2.0

    class _Torch(_CpuTorch):
        @staticmethod
        def _int_mm(a, b):
            return quant.int8_accumulate(a, b.t())

    monkeypatch.setattr(chip_smoke, "queued_ms", fake_queued)
    monkeypatch.setattr(chip_smoke, "time_ms", fake_time)
    rng = torch.Generator().manual_seed(0)
    rows = chip_smoke.check_ffn(_Torch(), F, ffn, cfg, rng, lambda m: None,
                                device="cpu")
    assert rows and timed == {"queued": 3 * chip_smoke.QUEUED_RUNS
                              * len(rows), "back to back": len(rows)}
    for r in rows:
        assert (r["ms"], r["plain_ms"], r["library_ms"]) == (1, 1, 1)
        assert r["enqueue_ms"] == 2 and r["not_queued"] == []
        assert r["split"] in (1, 2)
    timed.clear()
    block = chip_smoke.check_fused_block(_Torch(), fused_block, int8_matmul,
                                         quant, cfg, rng, lambda m: None,
                                         device="cpu")
    assert block and timed == {"queued": 4 * chip_smoke.QUEUED_RUNS
                               * len(block), "back to back": len(block)}
    for r in block:
        assert (r["ms"], r["plain_ms"], r["composed_ms"],
                r["library_ms"]) == (1, 1, 1, 1)
        assert r["enqueue_ms"] == 2 and r["not_queued"] == []
    for name, kernel_rows in (("fused_ffn", rows), ("fused_block", block)):
        per = chip_smoke.per_forward(kernel_rows, engine.VQA_LENGTH_MIX,
                                     chip_smoke.KINDS[name])
        n = sum(r["uses"].get("L=8", 0) for r in kernel_rows)
        assert per["L=8"]["ms"] == n and per["L=8"]["enqueue_ms"] == 2 * n
        assert math.isclose(per["mix"]["enqueue_ms"], 2 * per["mix"]["ms"])
