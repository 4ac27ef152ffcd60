"""A run with the timed path broken underneath comes out not correct:
every fault a cell can have, planted in the program at the rehearsal
sizes (one card: no exchange between chips to leave out)."""
import json

import pytest
import torch
import torch.nn.functional as F

from portbench.lib import harness


def rehearse(cell, capsys):
    rc = harness.main(["--workload", cell, "--seed", "2147483999",
                       "--seconds", "3", "--trace", "0", "--rehearse"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def broken_forward(real, fault):
    def build(*a, **k):
        run = real(*a, **k)

        def bad(*x):
            out = run(*x).clone()
            B = out.shape[0]
            if fault == "answer":
                out[:B // 4] = out[:B // 4] + 1
            else:   # half of the batch left out: its rows read 0
                out[B // 2:] = 0
            return out
        return bad
    return build


@pytest.mark.parametrize("cell,forward", [
    ("vqa-int8-mix", "serving_forward"),
    ("vqa-fused-mix", "fused_serving_forward")])
@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_vqa_faults_come_out_not_correct(cell, forward, fault, monkeypatch,
                                         capsys):
    from xlxmert_tpu_torch.cli import serve

    assert rehearse(cell, capsys)["correct"] is True
    monkeypatch.setattr(serve, forward,
                        broken_forward(getattr(serve, forward), fault))
    assert rehearse(cell, capsys)["correct"] is False


def broken_sampler(fault):
    """serving/sampling_int8.make_nar_sampler_int8 with a fault: a step
    that returns its state unchanged, or a cluster altered where the
    last step produces it."""
    from xlxmert_tpu_torch.serving import sampling_int8 as si

    def make(cfg, n_steps, grid_size=8, on_step=None):
        n_cells = grid_size * grid_size
        n_heads = cfg.num_attention_heads

        @torch.inference_mode()
        def sample(sp, centroids, input_ids, attention_mask):
            table, pos, code, ids, lang, lang_bias = si._start(
                sp, centroids, input_ids, attention_mask, n_cells,
                grid_size, n_heads)
            prob = torch.zeros(ids.shape, device=ids.device)
            mask_feat = sp.mask_feat[None, None, :]
            for i in range(n_steps):
                vis_mask = si.remask_by_rank(
                    prob, ((n_steps - i) * n_cells) // n_steps)
                feats = torch.where(vis_mask[..., None], mask_feat, code)
                logits = si._predict_from_lang(sp, lang, lang_bias, feats,
                                               pos, n_heads)
                if on_step is not None:
                    on_step(i, {"feats": feats, "vis_mask": vis_mask},
                            logits)
                prob, pred_id = si._log_prob_max(logits)
                if fault == "state_unchanged" and i == 1:
                    continue
                if fault == "token" and i == n_steps - 1:
                    pred_id = pred_id.clone()
                    pred_id[0] = (pred_id[0] + 1) % table.shape[0]
                code = torch.where(vis_mask[..., None],
                                   F.embedding(pred_id, table), code)
                ids = torch.where(vis_mask, pred_id, ids)
            return code, ids, prob
        return sample
    return make


@pytest.mark.parametrize("fault", ["state_unchanged", "token",
                                   "half_batch"])
def test_t2i_faults_come_out_not_correct(fault, monkeypatch, capsys):
    from xlxmert_tpu_torch.models import gan
    from xlxmert_tpu_torch.serving import sampling_int8

    assert rehearse("t2i-nar4-int8", capsys)["correct"] is True
    if fault == "half_batch":
        real = gan.render

        def render(gen, code):
            out = real(gen, code).clone()
            out[code.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(gan, "render", render)
    else:
        monkeypatch.setattr(sampling_int8, "make_nar_sampler_int8",
                            broken_sampler(fault))
    line = rehearse("t2i-nar4-int8", capsys)
    assert line["correct"] is False
