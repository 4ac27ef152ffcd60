"""The plain references against the program's plain versions (the
kernels' CPU paths) at the rehearsal sizes, on seeded weights: the
LXMERT-VQA forward and the X-LXMERT cluster head through the int8
engines, the render against the generator in fp32. Each also shows the
control one precision below reading farther off than the bar."""
import json
import os

import pytest
import torch

from portbench.lib import weights
from portbench.reference.lxmert import QuantLxmert, box_position
from portbench.reference.spade import Render

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        s = json.load(f)["sizes"]
    s.update(s.pop("rehearsal"))
    return s


def config(s):
    from xlxmert_tpu_torch.core.config import LxmertConfig

    return LxmertConfig(**{k: v for k, v in s.items()
                           if k in LxmertConfig.__dataclass_fields__})


def text(s, B, L, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(999, s["vocab_size"], (B, L), generator=g)
    ids[:, 0] = 101
    ids[B // 2:, L - 3:] = 0
    return ids, (ids > 0).float()


def calibrated(ref, batches, run):
    ref.calibrate(run, batches)
    return ref


@pytest.mark.parametrize("seed", [3, 4])
def test_lxmert_vqa_reference_follows_the_int8_engine(seed):
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine

    s = small("lxmert-base-vqa")
    cpu = torch.device("cpu")
    leaves, flat = weights.make(weights.lxmert_spec(s)
                                + weights.answer_head_spec(s), seed, 0.02,
                                cpu, torch)
    tree = weights.host_tree(leaves, flat, torch)
    cfg = config(s)
    qp = engine.prepare_params(tree["bert"], cfg, cpu)
    hqp = engine.prepare_answer_head(tree["answer_head"], cpu)
    B, L, V = 32, 12, s["visual_tokens"]
    ids, mask = text(s, B, L, seed)
    feats = torch.randn(B, V, s["visual_feat_dim"],
                        generator=torch.Generator().manual_seed(seed)
                        ).to(torch.bfloat16)
    pos = box_position(s["grid_size"])
    pb = pos.to(torch.bfloat16)[None]
    batches = [(ids[i:i + 8], feats[i:i + 8].float(), pb.expand(8, V, 4),
                mask[i:i + 8]) for i in range(0, B, 8)]
    engine.calibrate(qp, hqp, batches, cfg)
    engine.apply_calibration(qp, hqp)
    out = engine.vqa_forward(qp, hqp, ids, feats, pb.expand(B, V, 4),
                             attention_mask=mask,
                             n_heads=cfg.num_attention_heads)
    refs = {}
    for bits in (8, 4):
        ref = QuantLxmert(leaves, s["num_attention_heads"], bits)
        refs[bits] = calibrated(
            ref, [(i, f, m) for i, f, _, m in batches],
            lambda i, f, m, ref=ref: ref.vqa_logits(i, f, pos, m)
        ).vqa_logits(ids, feats.float(), pos, mask)
    # the engine carries bf16 between its int8 products: 3 % of the
    # logits' range at these widths; int4 is about ten times as far
    bar = 0.03 * float(refs[8].abs().max())
    assert float((out - refs[8]).abs().max()) <= bar
    assert float((refs[4] - refs[8]).abs().max()) > bar
    assert bool((out.argmax(-1) == refs[8].argmax(-1)).float().mean() >= 0.9)


@pytest.mark.parametrize("seed", [3, 4])
def test_cluster_head_reference_follows_the_int8_sampler(seed):
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.serving.lxmert_int8 import apply_calibration

    s = small("xlxmert-base")
    cpu = torch.device("cpu")
    leaves, flat = weights.make(weights.lxmert_spec(s)
                                + weights.object_head_spec(s), seed, 0.02,
                                cpu, torch)
    tree = weights.host_tree(leaves, flat, torch)
    cfg = config(s)
    params = {k: tree[k] for k in ("bert", "obj_predict_head", "mask_feat")}
    sp = si.prepare_sampler_params(params, cfg, tree["centroids"], cpu)
    B, L, G = 8, s["max_text_length"], s["grid_size"]
    ids, mask = text(s, B, L, seed)
    si.calibrate_sampler(sp, leaves["centroids"], ids, mask, cfg, G)
    apply_calibration(sp)
    g = torch.Generator().manual_seed(seed)
    table = leaves["centroids"].to(torch.bfloat16)
    cells = torch.randint(0, table.shape[0], (B, G * G), generator=g)
    masked = torch.rand(B, G * G, generator=g) < 0.5
    feats = torch.where(masked[..., None],
                        leaves["mask_feat"].to(torch.bfloat16), table[cells])
    pos = box_position(G)
    out = si._predict_forward(sp, ids, feats, pos.to(torch.bfloat16)[None]
                              .expand(B, -1, -1), mask,
                              cfg.num_attention_heads)
    cal = [(torch.where((torch.rand(B, G * G, generator=g) < f)[..., None],
                        leaves["mask_feat"].to(torch.bfloat16),
                        table[cells]).float(),) for f in (1.0, 0.5, 0.1)]
    refs = {}
    for bits in (8, 4):
        ref = QuantLxmert(leaves, s["num_attention_heads"], bits)

        def run(f, ref=ref):
            ref.cluster_logits(*ref.lang_encode(ids, mask), f, pos)

        calibrated(ref, cal, run)
        refs[bits] = ref.cluster_logits(*ref.lang_encode(ids, mask),
                                        feats.float(), pos)
    bar = 0.05 * float(refs[8].abs().max())
    assert float((out - refs[8]).abs().max()) <= bar
    assert float((refs[4] - refs[8]).abs().max()) > bar


@pytest.mark.parametrize("seed", [3, 4])
def test_render_reference_equals_the_generator_in_fp32(seed):
    from xlxmert_tpu_torch.models import gan

    s = small("xlxmert-base")
    leaves, _ = weights.make(weights.generator_spec(s), seed, 0.02,
                             torch.device("cpu"), torch)
    weights.converge_spectral_norms(leaves, torch)
    gen = gan.Generator(emb_dim=s["visual_feat_dim"],
                        base_dim=s["g_base_dim"],
                        target_size=s["target_size"],
                        init_H=s["grid_size"], init_W=s["grid_size"],
                        codebook_dim=s["codebook_dim"],
                        dtype=torch.float32)
    gen.load_state_dict(leaves)
    code = torch.randn(4, s["grid_size"] ** 2, s["visual_feat_dim"],
                       generator=torch.Generator().manual_seed(seed))
    out = gan.render(gen.eval(), code)
    ref = Render(leaves, s)(code)
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((Render(leaves, s, fp8=True)(code) - ref).abs().max()) \
        > 1e-3
