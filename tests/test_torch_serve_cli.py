"""Port's `cli/serve --device cpu` against `xlxmert_tpu.cli.serve` on the
same checkpoint, h5 catalog, vocab and questions (the fixture pattern of
tests/test_cli_extra.py), plus the checkpoint readers and tokenizer the
CLI goes through."""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.cli.serve import main as jax_serve
from xlxmert_tpu.core.checkpoint import save_pytree
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.core.convert import convert_torch_state_dict as jax_convert
from xlxmert_tpu.data.tokenization import Tokenizer as JaxTokenizer
from xlxmert_tpu.models.task_heads import VQAModel
from xlxmert_tpu_torch.cli.serve import main as torch_serve
from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint, load_pytree
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.core.convert import convert_torch_state_dict
from xlxmert_tpu_torch.data.tokenization import Tokenizer

WORDS = ["what", "is", "the", "dog", "cat", "red", "color"]
ANSWERS = ["yes", "no", "maybe"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both CLIs, unbucketed and bucketed, on one tiny fixture."""
    import h5py

    tmp = tmp_path_factory.mktemp("serve")
    cfg = JaxConfig(vocab_size=30, hidden_size=32, num_attention_heads=4,
                    intermediate_size=64, l_layers=1, x_layers=1,
                    r_layers=1, visual_feat_dim=16, num_clusters=0)
    cfg.save(str(tmp / "model.yaml"))
    rng = np.random.RandomState(0)
    with h5py.File(tmp / "grid2.h5", "w") as f:
        for i in range(6):
            f.create_group(f"img_{i}").create_dataset(
                "features",
                data=rng.randn(2, 2, 16).astype(np.float32) * 0.3)
    with open(tmp / "vocab.txt", "w") as f:
        for t in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS:
            f.write(t + "\n")
    (tmp / "label2ans.json").write_text(json.dumps(ANSWERS))
    qs = [{"question_id": i, "img_id": f"img_{i % 6}",
           "sent": " ".join(rng.choice(WORDS, 4))} for i in range(10)]
    with open(tmp / "qs.jsonl", "w") as f:
        for q in qs:
            f.write(json.dumps(q) + "\n")
    model = VQAModel(cfg, num_answers=3, dtype=jnp.float32)
    params = model.init(
        jax.random.PRNGKey(0), jnp.ones((2, 20), jnp.int32),
        jnp.zeros((2, 4, 16)), jnp.zeros((2, 4, 4)),
        attention_mask=jnp.ones((2, 20)))["params"]
    save_pytree(jax.tree.map(np.asarray, params), str(tmp / "BEST.msgpack"))

    common = ["--load", str(tmp / "BEST.msgpack"),
              "--model_config", str(tmp / "model.yaml"),
              "--h5", str(tmp / "grid2.h5"),
              "--vocab", str(tmp / "vocab.txt"),
              "--label2ans", str(tmp / "label2ans.json"),
              "--questions", str(tmp / "qs.jsonl"), "--batch", "4"]
    out = {}
    for name, extra in (("flat", []), ("bkt", ["--buckets", "8,12"])):
        jax_serve(common + ["--output", str(tmp / f"jax_{name}.jsonl")]
                  + extra)
        torch_serve(common + ["--output", str(tmp / f"torch_{name}.jsonl"),
                              "--device", "cpu"] + extra)
        for pkg in ("jax", "torch"):
            with open(tmp / f"{pkg}_{name}.jsonl") as f:
                out[pkg, name] = [json.loads(line) for line in f
                                  if line.strip()]
    return out, tmp, common, params


def test_unbucketed_answers_agree_in_question_order(served):
    out, *_ = served
    ref, got = out["jax", "flat"], out["torch", "flat"]
    assert [a["question_id"] for a in got] == list(range(10))
    assert [a["question_id"] for a in got] == [a["question_id"] for a in ref]
    assert all(a["answer"] in ANSWERS for a in got)
    agree = sum(a["answer"] == b["answer"] for a, b in zip(got, ref))
    assert agree >= 8, f"{agree}/10 agree"


def test_profile_traces_the_engine_stages_and_keeps_the_answers(served):
    """--profile DIR: the batches after the warm-up one in a Chrome trace
    whose ranges are the serving forward's stages; the same answers."""
    out, tmp, common, _ = served
    torch_serve(common + ["--output", str(tmp / "torch_prof.jsonl"),
                          "--device", "cpu", "--profile",
                          str(tmp / "prof")])
    with open(tmp / "torch_prof.jsonl") as f:
        assert [json.loads(line) for line in f] == out["torch", "flat"]
    (trace,) = (tmp / "prof").glob("*.pt.trace.json")
    names = [e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]]
    # 10 questions in batches of 4: two traced forwards
    for stage in ("xlt.serve.inputs", "xlt.engine.language",
                  "xlt.engine.visual", "xlt.engine.cross", "xlt.serve.head"):
        assert names.count(stage) == 2, stage


def test_bucketed_answers_cover_every_question_and_agree(served):
    out, *_ = served
    ref = {a["question_id"]: a["answer"] for a in out["jax", "bkt"]}
    got = out["torch", "bkt"]
    assert sorted(a["question_id"] for a in got) == list(range(10))
    agree = sum(ref[a["question_id"]] == a["answer"] for a in got)
    assert agree >= 8, f"{agree}/10 agree"


def test_bf16_flag_is_not_ported_yet(served):
    """--bf16 serves the bf16 VQAModel; on the CPU it gives the JAX
    package's --bf16 answers (both take the einsum attention and the
    unfused FFN there). bf16 rounding may swap a near-tie: 8 of 10."""
    _, tmp, common, _ = served
    answers = {}
    for pkg, run, extra in (("jax", jax_serve, []),
                            ("torch", torch_serve, ["--device", "cpu"])):
        out = tmp / f"{pkg}_bf16.jsonl"
        run(common + ["--output", str(out), "--bf16", "--buckets", "8,12"]
            + extra)
        with open(out) as f:
            answers[pkg] = {a["question_id"]: a["answer"]
                            for a in map(json.loads, f) if a}
    assert sorted(answers["torch"]) == list(range(10))
    agree = sum(answers["jax"][i] == a for i, a in answers["torch"].items())
    assert agree >= 8, f"{agree}/10 agree"


def test_serve_fused_gives_the_int8_answers(served):
    """serve(fused=True) runs the whole-block fused engine on the
    calibrated int8 engine; on the CPU the two are bit-equal, so they
    answer alike. It does not combine with bf16=True."""
    from xlxmert_tpu_torch.cli.serve import serve
    from xlxmert_tpu_torch.data.io import GridFeatureReader
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

    _, tmp, _, _ = served
    cfg = LxmertConfig.from_yaml(str(tmp / "model.yaml"))
    params = load_any_checkpoint(str(tmp / "BEST.msgpack"))
    with open(tmp / "qs.jsonl") as f:
        qs = [json.loads(line) for line in f if line.strip()]
    with GridFeatureReader(str(tmp / "grid2.h5")) as reader:
        cache = FeatureCache.build(reader, [f"img_{i}" for i in range(6)],
                                   device="cpu")
    answers, calibrated = {}, []
    for fused in (False, True):
        out = tmp / f"fused_{fused}.jsonl"
        res = serve(qs, Tokenizer(str(tmp / "vocab.txt")), cache, params,
                    cfg, ANSWERS, str(out), batch=4, buckets="8,12",
                    device="cpu", fused=fused,
                    on_calibrated=lambda: calibrated.append(fused))
        with open(out) as f:
            answers[fused] = {a["question_id"]: a["answer"]
                              for a in map(json.loads, f)}
        assert res["calib_forwards"] + res["serve_forwards"] \
            == res["forwards"]
    assert type(res["engine"][0]).__name__ == "LxmertFused"
    assert calibrated == [False, True]
    assert sorted(answers[True]) == list(range(10))
    assert answers[True] == answers[False]
    with pytest.raises(ValueError, match="bf16"):
        serve(qs, None, cache, params, cfg, ANSWERS, str(tmp / "x.jsonl"),
              device="cpu", fused=True, bf16=True)


def test_msgpack_checkpoint_reads_like_flax(served):
    _, tmp, _, params = served
    got = load_any_checkpoint(str(tmp / "BEST.msgpack"))
    want = jax.tree_util.tree_leaves_with_path(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf))
    cfg = LxmertConfig.from_yaml(str(tmp / "model.yaml"))
    assert cfg.hidden_size == 32 and cfg.l_layers == 1


def test_msgpack_bf16_scalar_and_full_state_leaves(tmp_path):
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "h": jnp.asarray([1.5, -2.25], jnp.bfloat16)},
            "opt_state": {"count": np.int32(7)}, "step": np.int64(3)}
    save_pytree(tree, str(tmp_path / "full.msgpack"))
    params = load_any_checkpoint(str(tmp_path / "full.msgpack"))
    np.testing.assert_array_equal(params["w"], tree["params"]["w"])
    np.testing.assert_array_equal(params["h"], [1.5, -2.25])
    full = load_pytree(str(tmp_path / "full.msgpack"))
    assert full["step"] == 3 and full["opt_state"]["count"] == 7


def test_torch_state_dict_converts_like_jax(tmp_path):
    sd = {"module.encoder.layer.0.attention.self.query.weight":
          torch.randn(6, 4),
          "encoder.layer.0.attention.self.query.bias": torch.randn(6),
          "embeddings.word_embeddings.weight": torch.randn(5, 4),
          "encoder.layer.0.output.LayerNorm.weight": torch.randn(4),
          "cls.predictions.decoder.weight": torch.randn(5, 4)}
    ref = jax_convert(sd)
    got = convert_torch_state_dict(sd)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    torch.save(sd, tmp_path / "ckpt.pth")
    loaded = load_any_checkpoint(str(tmp_path / "ckpt.pth"))
    assert jax.tree.structure(loaded) == jax.tree.structure(ref)


def test_tokenizer_copy_matches_jax(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is",
             "the", "dog", "##s", "color", "?", "caf", "##e"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    sents = ["What is the dog's color?", "dogs  CAFÉ", "the " * 30, "",
             "unknownword is"]
    np.testing.assert_array_equal(
        Tokenizer(str(path)).encode_batch(sents, 12),
        JaxTokenizer(str(path)).encode_batch(sents, 12))
