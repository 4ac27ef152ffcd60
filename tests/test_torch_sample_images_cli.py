"""Port's `cli/sample_images` on the CPU, end to end at a tiny width: JAX-
format checkpoints (X-LXMERT and the generator), centroids, vocabulary
and sentences on disk; NAR and AR, bf16 and int8, rendered PNGs that
decode to the rendered array; the random AR order and the int8
calibration sentences the JAX CLI draws; its refusals."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

import xlxmert_tpu.tasks.sampling as jsam
from xlxmert_tpu.cli.sample_images import main as jax_main
from xlxmert_tpu_torch.cli import sample_images as cli
from xlxmert_tpu_torch.core.checkpoint import save_pytree
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.data.tokenization import Tokenizer
from xlxmert_tpu_torch.models import gan
from xlxmert_tpu_torch.tasks import sampling as tsam

WORDS = ["a", "red", "dog", "on", "the", "grass", "two", "cats", "sleep"]
SHAPE = dict(vocab_size=20, hidden_size=32, num_attention_heads=4,
             intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
             visual_feat_dim=16, num_clusters=21)
GRID = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sample")
    cfg = LxmertConfig(**SHAPE)
    cfg.save(str(tmp / "model.yaml"))
    save_pytree(tsam.random_params(cfg, seed=1), str(tmp / "x.msgpack"))
    rng = np.random.RandomState(0)
    np.save(tmp / "centroids.npy", rng.randn(21, 16).astype(np.float32))
    save_pytree(gan.random_variables(16, 8, 32, GRID, 8, seed=2),
                str(tmp / "g.msgpack"))
    with open(tmp / "vocab.txt", "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + WORDS) + "\n")
    sents = [" ".join(rng.choice(WORDS, rng.randint(2, 6)))
             for _ in range(5)] + ["a dog!"]
    (tmp / "sents.txt").write_text("\n".join(sents) + "\n\n")
    common = ["--load", str(tmp / "x.msgpack"),
              "--centroids", str(tmp / "centroids.npy"),
              "--model_config", str(tmp / "model.yaml"),
              "--vocab", str(tmp / "vocab.txt"),
              "--sentences", str(tmp / "sents.txt"),
              "--grid_size", str(GRID), "--batch_size", "4",
              "--max_text_length", "8", "--target_size", "32",
              "--g_base_dim", "8", "--codebook_dim", "8"]
    return tmp, common, sents


def _pngs(out_dir):
    return sorted(out_dir.glob("*.png"))


@pytest.mark.parametrize("extra", [
    ["--sample_steps", "2", "--save_intermediate"],
    ["--int8", "--sample_steps", "3", "--fast_render"],
    ["--sample_mode", "AR", "--position_strategy", "random"],
    ["--int8", "--sample_mode", "AR", "--position_strategy", "TLBR"]],
    ids=["nar", "nar-int8", "ar-random", "ar-int8-tlbr"])
def test_cli_samples_and_renders_on_the_cpu(files, extra):
    tmp, common, sents = files
    out_dir = tmp / ("out_" + "_".join(extra).replace("-", ""))
    res = cli.main(common + ["--generator", str(tmp / "g.msgpack"),
                             "--output", str(out_dir), "--device", "cpu"]
                   + extra)
    n = len(sents)
    assert res["ids"].shape == (n, GRID * GRID)
    assert ((res["ids"] >= 0) & (res["ids"] < 21)).all()
    assert res["images"].shape == (n, 32, 32, 3)
    assert len(res["sample_s"]) == len(res["render_s"]) == 2
    table = np.load(tmp / "centroids.npy")
    if "--int8" in extra:
        table = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(res["codes"].float().numpy(),
                                  table[res["ids"]])
    pngs = _pngs(out_dir)
    assert [p.name[:4] for p in pngs] == [f"{i:04d}" for i in range(n)]
    assert pngs[-1].name == "0005_a_dog.png"
    for p, img in zip(pngs, res["images"]):
        with Image.open(p) as im:
            assert im.mode == "RGB" and im.size == (32, 32)
            np.testing.assert_array_equal(np.asarray(im),
                                          (img * 255).astype(np.uint8))
    if "--save_intermediate" in extra:
        assert [len(_pngs(out_dir / f"step{t}")) for t in range(2)] == [n, n]
        # the last step's grid is the final one
        for p, q in zip(_pngs(out_dir / "step1"), pngs):
            assert p.read_bytes() == q.read_bytes()


def test_profile_traces_the_sampler_and_render_stages(files):
    """--profile DIR: the batches after the first in a Chrome trace whose
    ranges are the int8 NAR sampler's and the render's stages."""
    tmp, common, sents = files
    res = cli.main(common + ["--generator", str(tmp / "g.msgpack"),
                             "--output", str(tmp / "out_prof"), "--device",
                             "cpu", "--int8", "--sample_steps", "2",
                             "--profile", str(tmp / "prof")])
    assert res["ids"].shape == (len(sents), GRID * GRID)
    (trace,) = (tmp / "prof").glob("*.pt.trace.json")
    names = [e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]]
    # 6 sentences in batches of 4: the second batch traced
    assert names.count("xlt.sampler.language") == 1
    assert names.count("xlt.render") == 1
    for stage in ("remask", "visual", "cross", "head", "commit"):
        assert names.count(f"xlt.sampler.{stage}") == 2, stage


def test_cli_without_a_generator_saves_the_ids(files):
    tmp, common, sents = files
    out_dir = tmp / "codes"
    res = cli.main(common + ["--output", str(out_dir), "--device", "cpu",
                             "--int8"])
    assert res["images"] is None and res["render_s"] == []
    got = np.concatenate([np.load(out_dir / f"codes_{s:04d}.npy")
                          for s in (0, 4)])
    np.testing.assert_array_equal(got, res["ids"])


def test_random_order_and_calibration_sentences_are_the_jax_clis(
        files, monkeypatch):
    """The AR random order: one RandomState(--seed).permutation per
    batch, as the JAX CLI draws it (both samplers replaced by recorders);
    the int8 calibration batch: sentences spread over the whole stream."""
    tmp, common, sents = files
    seen = {"jax": [], "torch": []}

    def recorder(key, n_cells, D=16):
        def make(*a, **kw):
            def sample(*args):
                seen[key].append(np.asarray(args[-1]).tolist())
                B = args[-3].shape[0]
                zeros = (np.zeros if key == "jax" else torch.zeros)
                return (zeros((B, n_cells, D)),
                        zeros((B, n_cells), dtype=np.int32
                              if key == "jax" else torch.long))
            return sample
        return make

    monkeypatch.setattr(jsam, "make_ar_sampler", recorder("jax", 16))
    monkeypatch.setattr(tsam, "make_ar_sampler", recorder("torch", 16))
    args = common + ["--sample_mode", "AR", "--position_strategy",
                     "random", "--seed", "17"]
    jax_main(args + ["--output", str(tmp / "jax_order")])
    cli.main(args + ["--output", str(tmp / "torch_order"), "--device",
                     "cpu"])
    rng = np.random.RandomState(17)
    assert seen["jax"] == seen["torch"] == [
        rng.permutation(16).tolist() for _ in range(2)]

    tok = Tokenizer(str(tmp / "vocab.txt"))
    ids = cli.calibration_ids(sents, tok, 4, 8)
    want = [sents[i] for i in (0, 1, 3, 5)]   # linspace(0, 5, 4)
    np.testing.assert_array_equal(ids, tok.encode_batch(want, 8))
    np.testing.assert_array_equal(
        cli.calibration_ids(sents[:2], tok, 4, 8),
        tok.encode_batch(sents[:2] + ["", ""], 8))


def test_refusals_and_the_default_device(files, tmp_path):
    tmp, common, _ = files
    with pytest.raises(SystemExit, match="save_intermediate"):
        cli.main(common + ["--int8", "--save_intermediate", "--device",
                           "cpu", "--output", str(tmp_path / "o")])
    no_centroids = [a for i, a in enumerate(common)
                    if a != "--centroids"
                    and (i == 0 or common[i - 1] != "--centroids")]
    with pytest.raises(SystemExit, match="--centroids required"):
        cli.main(no_centroids + ["--device", "cpu"])
    ns = cli.parse_args(common)
    assert ns.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(common + ["--output", str(tmp_path / "o")])
