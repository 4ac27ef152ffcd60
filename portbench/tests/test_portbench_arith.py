"""The yardstick's counts: launches a forward, operations an answer and
a sample, and the render's operations against torch's flop counter on
the program's generator."""
import json
import os

import pytest

from portbench.lib import arith

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sizes(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        s = json.load(f)["sizes"]
    s.pop("rehearsal")
    return s


def kinds(launches):
    out = {}
    for ln in launches:
        out[ln.kernel] = out.get(ln.kernel, 0) + 1
    return out


@pytest.mark.parametrize("L", [8, 12, 16, 20])
def test_launches_of_a_serving_forward(L):
    s = sizes("lxmert-base-vqa")
    assert kinds(arith.vqa_forward_launches(s, 256, L, "int8")) == {
        "int8_dense": 129, "mha_blhd": 34}
    assert kinds(arith.vqa_forward_launches(s, 256, L, "fused")) == {
        "int8_dense": 5, "fused_block": 34, "mha_blhd": 34}


def test_launches_of_a_sampler_batch():
    s = sizes("xlxmert-base")
    got = kinds(arith.sampler_launches(s, 64, 20, 4))
    assert got == {"int8_dense": 36 + 4 * 87, "mha_blhd": 9 + 4 * 23}


@pytest.mark.parametrize("L,gop", [(8, 12.70), (12, 13.60), (16, 14.50),
                                   (20, 15.40)])
def test_operations_an_answer(L, gop):
    ops = arith.vqa_forward_ops(sizes("lxmert-base-vqa"), L)
    assert round(sum(ops.values()) / 1e9, 2) == gop


def test_operations_an_answer_over_the_mix():
    s = sizes("lxmert-base-vqa")
    mix = {8: 0.35, 12: 0.45, 16: 0.15, 20: 0.05}
    total = sum(p * sum(arith.vqa_forward_ops(s, L).values())
                for L, p in mix.items())
    assert round(total / 1e9, 2) == 13.51


def test_the_bound_takes_the_slower_of_bytes_and_operations():
    assert arith.bound_s(3.35e12, 0.0, "int8") == pytest.approx(1.0)
    assert arith.bound_s(0.0, 989e12, "bfloat16") == pytest.approx(1.0)
    ln = arith.dense_launch(256 * 20, 768, 768)
    assert ln.bound_s == pytest.approx(max(ln.nbytes / 3.35e12,
                                           ln.ops / 1979e12))


def test_render_operations_match_the_flop_counter_on_the_generator():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from xlxmert_tpu_torch.models.gan import Generator

    s = dict(sizes("xlxmert-base"), target_size=64)
    gen = Generator(emb_dim=s["visual_feat_dim"], base_dim=s["g_base_dim"],
                    target_size=64, init_H=8, init_W=8,
                    codebook_dim=s["codebook_dim"], use_sn=False).eval()
    for p in gen.parameters():
        torch.nn.init.normal_(p, std=0.02)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        gen(torch.zeros(1, 64, s["visual_feat_dim"]))
    assert fc.get_total_flops() == pytest.approx(arith.render_ops(s),
                                                 rel=1e-9)


def test_the_vqa_mix_follows_the_published_word_statistic():
    import numpy as np

    from portbench.lib import traffic

    with open(os.path.join(BENCH, "traffic", "vqa-mix.json")) as f:
        mix = json.load(f)
    mix.pop("rehearsal")
    shares = {b: round(100 * p, 2)
              for b, (p, _) in traffic.bucket_shares(mix).items()}
    assert shares == {8: 36.18, 12: 58.86, 16: 4.94, 20: 0.01}
    a = traffic.generate(mix, 2**31 + 11, 30522, 10)
    b = traffic.generate(mix, 2**33 + 7, 30522, 10)
    assert [x.length for x in a.batches] == [x.length for x in b.batches]
    assert len(a.batches) == 839 and a.batches[0].length == 20
    tokens = (a.ids > 0).sum(1)
    assert abs(tokens.mean() - (6.2 + 3)) < 0.05
    assert tokens.min() >= 4 and tokens.max() <= 20
    # every row no longer than its batch's length
    for x in a.batches[:50]:
        assert np.all(tokens[x.rows] <= x.length)
