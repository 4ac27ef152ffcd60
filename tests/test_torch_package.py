"""Package rules of the PyTorch port: it imports neither JAX, flax nor
the JAX package, and its entry points run on the card unless the caller
asks for the CPU."""
import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "xlxmert_tpu")


def _port_scripts():
    """chip_smoke.py, the rank bodies of the multi-process tests (a
    spawned rank re-imports them) and the port's scripts
    (scripts/*_torch*.py)."""
    scripts = os.path.join(ROOT, "scripts")
    return [os.path.join(ROOT, "chip_smoke.py"),
            os.path.join(ROOT, "tests", "torch_rank_bodies.py")] + [
        os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
        if "_torch" in n and n.endswith(".py")]


def _port_files():
    pkg = os.path.join(ROOT, "xlxmert_tpu_torch")
    files = _port_scripts()
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_flax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    assert os.path.join(ROOT, "scripts", "drive_attention_layout_torch.py") \
        in files
    parallel = os.path.join(ROOT, "xlxmert_tpu_torch", "parallel")
    assert {os.path.join(parallel, f"{m}.py") for m in (
        "__init__", "mesh", "sharding", "pipeline", "launch")} \
        <= set(files)
    bad = {(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_every_port_module_imports():
    import importlib

    for f in _port_files():
        rel = os.path.relpath(f, ROOT)
        if f in _port_scripts():
            continue
        importlib.import_module(rel[:-3].replace(os.sep, ".").replace(
            ".__init__", ""))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_need_the_card_unless_asked_for_the_cpu(no_cuda,
                                                             tmp_path):
    from xlxmert_tpu_torch.cli.serve import main, serve
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

    cfg = LxmertConfig(vocab_size=20, hidden_size=32, num_attention_heads=4,
                       intermediate_size=64, l_layers=1, x_layers=1,
                       r_layers=1, visual_feat_dim=16)
    bert, head = engine.random_params(cfg, 3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.prepare_params(bert, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.prepare_answer_head(head)

    class Reader:
        def get(self, img_id):
            return np.zeros((2, 2, 16), np.float32)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureCache.build(Reader(), ["a"])
    cache = FeatureCache.build(Reader(), ["a"], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve([{"question_id": 0, "img_id": "a", "sent": "x"}], None, cache,
              {"bert": bert, "answer_head": head}, cfg, ["y"],
              str(tmp_path / "a.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--load", "x", "--h5", "x", "--vocab", "x", "--label2ans",
              "x", "--questions", "x", "--output", "x"])
    qp = engine.prepare_params(bert, cfg, device="cpu")
    assert qp.embeddings.word.device.type == "cpu"
    from xlxmert_tpu_torch.core.config import TrainConfig
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        PretrainEngine(TrainConfig(), cfg)
    assert PretrainEngine(TrainConfig(), cfg, device="cpu").device.type \
        == "cpu"


def test_sampling_entry_points_need_the_card_unless_asked_for_the_cpu(
        no_cuda):
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.tasks import sampling

    cfg = LxmertConfig(vocab_size=20, hidden_size=32, num_attention_heads=4,
                       intermediate_size=64, l_layers=1, x_layers=1,
                       r_layers=1, visual_feat_dim=16, num_clusters=5)
    params = sampling.random_params(cfg, seed=0)
    cent = np.zeros((5, 16), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        si.prepare_sampler_params(params, cfg, cent)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sampling.sampler_model(params, cfg)
    assert si.prepare_sampler_params(params, cfg, cent, "cpu").mask_feat \
        .device.type == "cpu"
    assert next(sampling.sampler_model(params, cfg, device="cpu")
                .parameters()).device.type == "cpu"


def test_gan_training_entry_points_need_the_card_unless_asked_for_the_cpu(
        no_cuda, tmp_path):
    from xlxmert_tpu_torch.cli import train_generator as cli
    from xlxmert_tpu_torch.core.config import GanConfig
    from xlxmert_tpu_torch.tasks.train_generator import GanEngine

    cfg = GanConfig(emb_dim=16, codebook_dim=8, g_base_dim=8, d_base_dim=8,
                    init_H=4, init_W=4, target_size=16, n_classes=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GanEngine(cfg)
    np.save(tmp_path / "c.npy", np.zeros((3, 16), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--images_dir", str(tmp_path), "--centroids",
                  str(tmp_path / "c.npy"), "--cluster_pkl", "x",
                  "--output", str(tmp_path / "out")])
    eng = GanEngine(cfg, device="cpu")
    state = eng.create_state(0, np.zeros((3, 16), np.float32))
    assert eng.device.type == "cpu" and next(
        state.D.parameters()).device.type == "cpu"
    assert state.generator.device.type == "cpu"


def test_factory_entry_points_need_the_card_unless_asked_for_the_cpu(
        no_cuda, tmp_path):
    from xlxmert_tpu_torch.cli import extract_bbox_features, extract_features
    from xlxmert_tpu_torch.cli import run_kmeans
    from xlxmert_tpu_torch.vocab import kmeans

    x = np.random.RandomState(0).randn(40, 4).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans.kmeans(x, 3, n_iter=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans.assign(x, x[:3])
    centroids, ids = kmeans.kmeans(x, 3, n_iter=1, device="cpu")
    assert centroids.shape == (3, 4) and ids.shape == (40,)
    for main, argv in (
            (run_kmeans.main, ["--src_h5", "x.h5"]),
            (extract_features.main, ["--images_dir", str(tmp_path),
                                     "--out", "x.h5"]),
            (extract_features.main, ["--arch", "maskrcnn", "--images_dir",
                                     str(tmp_path), "--out", "x.h5"]),
            (extract_bbox_features.main, ["--images_dir", str(tmp_path),
                                          "--out", "x.h5"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_fid_entry_points_need_the_card_unless_asked_for_the_cpu(
        no_cuda, tmp_path):
    from xlxmert_tpu_torch.cli import eval_fid
    from xlxmert_tpu_torch.models.inception import (
        inception_from_variables, random_variables,
    )
    from xlxmert_tpu_torch.utils import fid

    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_fid.main(["--real_dir", str(tmp_path), "--fake_dir",
                       str(tmp_path)])
    model = inception_from_variables(random_variables(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fid.inception_feature_fn(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_fid.feature_fn("resnet", {})
    fn = fid.inception_feature_fn(model, "cpu")
    assert fn(np.zeros((1, 299, 299, 3), np.float32)).shape == (1, 2048)


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    from xlxmert_tpu_torch.ops import attention, fused_block, int8_matmul
    from xlxmert_tpu_torch.ops.quant import (
        quantize_weight, with_activation_scale,
    )

    q = torch.randn(2, 5, 32)
    before = attention.KERNEL.launches
    out = attention.mha_blhd(q, q, q, None, 2, fast=False)
    torch.testing.assert_close(
        out, attention.mha_blhd_reference(q, q, q, None, 2, fast=False))
    qw = quantize_weight(np.ones((32, 8), np.float32))
    int8_matmul.int8_dense_fused(q.to(torch.bfloat16), qw.w_i8, qw.scale)
    assert attention.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        attention.mha_blhd(q.to("meta"), q.to("meta"), q.to("meta"), None,
                           2)
    qb = q.to(torch.bfloat16)
    before = attention.HBATCH_KERNEL.launches
    assert torch.equal(attention.mha_hbatch(qb, qb, qb, None, 2),
                       attention.mha_hbatch_reference(qb, qb, qb, None, 2))
    assert attention.HBATCH_KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        attention.mha_hbatch(qb.to("meta"), qb.to("meta"), qb.to("meta"),
                             None, 2)
    fw = fused_block.fused_weight(with_activation_scale(
        quantize_weight(np.ones((32, 32), np.float32)), 1.0))
    x, g, b = q[0].to(torch.bfloat16), torch.ones(32), torch.zeros(32)
    before = fused_block.KERNEL.launches
    y = fused_block.fused_block(x, x, fw, g, b, has_ffn=False)
    assert torch.equal(y, fused_block.fused_block_reference(
        x, x, fw, fused_block.LN(g, b)))
    assert fused_block.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block.fused_block(x.to("meta"), x.to("meta"), fw, g, b,
                                has_ffn=False)


def test_the_native_runtime_and_int8_attention_build_nothing_at_import():
    """The last modules ported (runtime/, data/fast_tokenizer,
    ops/attention_int8) are port modules under the import rule above,
    and importing them compiles nothing: the tokenizer's library and
    the kernel are built at first use."""
    import subprocess
    import sys

    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {os.path.join("xlxmert_tpu_torch", *p) for p in (
        ("runtime", "__init__.py"), ("data", "fast_tokenizer.py"),
        ("ops", "attention_int8.py"))} <= files
    code = ("import xlxmert_tpu_torch.data.fast_tokenizer as f, "
            "xlxmert_tpu_torch.ops.attention_int8 as a, "
            "xlxmert_tpu_torch.serving.lxmert_int8 as e; "
            "print(len(f._LIBS), a.KERNEL._lib is None, "
            "a.KERNEL.launches, e._INT8_ATTENTION)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "True", "0", "False"]
