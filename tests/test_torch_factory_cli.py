"""The port's factory CLIs (xlxmert_tpu_torch/cli/{run_kmeans,
extract_features,extract_bbox_features}.py, --device cpu) against the
JAX package's on the same files: the same output names, h5 keys and
shapes, cluster mappings, and features within the model tests' bars;
and the port's copy of data/corpora against the JAX package's."""
import argparse
import importlib
import os
import pickle
import sys

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from xlxmert_tpu.data import corpora as jcorp
from xlxmert_tpu_torch.core.checkpoint import save_pytree
from xlxmert_tpu_torch.data import corpora as tcorp
from xlxmert_tpu_torch.models import detectron as D

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli_extra import _torchvision_resnet50_state_dict  # noqa: E402
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores")


def read_h5(path):
    with h5py.File(path) as f:
        return {k: {n: f[k][n][()] for n in f[k]} for k in f}


def assert_features_close(got, ref):
    assert got.shape == ref.shape
    a, b = got.astype(np.float64).ravel(), ref.astype(np.float64).ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99999
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def write_grid_h5(path, n_images, centers, rng):
    """n_images of 2x2 grids whose cells are exactly one of `centers`."""
    with h5py.File(path, "w") as f:
        for i in range(n_images):
            cells = centers[rng.randint(len(centers), size=4)]
            f.create_group(f"img{i:03d}").create_dataset(
                "features", data=cells.reshape(2, 2, -1))


def test_run_kmeans_cli_writes_what_the_jax_cli_writes(tmp_path):
    """Cells that are exact copies of 4 centres: ids are exact ties or
    far apart, so both CLIs give the same mappings; the same .npy and
    .pkl names, the centroids within 1e-5."""
    from xlxmert_tpu.cli.run_kmeans import main as jmain
    from xlxmert_tpu_torch.cli.run_kmeans import main as tmain

    rng = np.random.RandomState(0)
    centers = (rng.randn(4, 16) * 3).astype(np.float32)
    src = tmp_path / "maskrcnn_train_grid2.h5"
    extra = tmp_path / "maskrcnn_valid_grid2.h5"
    write_grid_h5(src, 20, centers, rng)
    write_grid_h5(extra, 7, centers, rng)
    out = {}
    for name, main, dev in (("jax", jmain, []),
                            ("torch", tmain, ["--device", "cpu"])):
        d = tmp_path / name
        main(["--src_h5", str(src), "--assign_h5", str(extra),
              "--out_dir", str(d / "c"), "--cluster_dir", str(d / "ids"),
              "--n_centroids", "4", "--n_iter", "3", "--grid_size", "2",
              "--seed", "1"] + dev)
        out[name] = ({p.name: np.load(p) for p in (d / "c").iterdir()},
                     {p.name: pickle.load(open(p, "rb"))
                      for p in (d / "ids").iterdir()})
    (jc, jids), (tc, tids) = out["jax"], out["torch"]
    assert sorted(tc) == sorted(jc) == [
        "maskrcnn_mscoco_train_centroids4_iter3_d16_grid2.npy"]
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-5, atol=1e-5)
    assert sorted(tids) == sorted(jids) == sorted(
        f"maskrcnn_{s}_img_id_to_cluster_id_4_iter3_d16_grid2.pkl"
        for s in ("train", "valid"))
    for k in jids:
        assert sorted(tids[k]) == sorted(jids[k])
        for img, ids in jids[k].items():
            assert tids[k][img].dtype == np.int64
            np.testing.assert_array_equal(tids[k][img], ids)


def images_dir(tmp_path, shapes, name="imgs"):
    rng = np.random.RandomState(0)
    d = tmp_path / name
    d.mkdir()
    for i, (h, w) in enumerate(shapes):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            d / f"im{i}.jpg")
    return d


def detectron_weights(tmp_path, n_classes=None):
    """A tiny detector's random tree as a flat maskrcnn-benchmark state
    dict in a msgpack, which both CLIs' --weights read."""
    sd = D.params_to_state_dict(D.random_params(
        D.tiny_detectron_config(), 7, n_classes=n_classes),
        D.tiny_detectron_config())
    path = tmp_path / f"detectron{n_classes}.msgpack"
    save_pytree({k: v.numpy() for k, v in sd.items()}, str(path))
    return str(path)


@pytest.mark.parametrize("size", ["64", "0"])
def test_extract_features_maskrcnn_matches_the_jax_cli(tmp_path, size):
    """--arch maskrcnn --tiny_detectron, square (--image_size 64) and
    the reference's min-800/max-1333 mode (0, one small image), the same
    weights: the same ids and (G, G, D) shapes, features within 1e-4."""
    from xlxmert_tpu.cli.extract_features import main as jmain
    from xlxmert_tpu_torch.cli.extract_features import main as tmain

    shapes = [(48, 64), (64, 48), (36, 36)] if size != "0" else [(40, 52)]
    d = images_dir(tmp_path, shapes)
    w = detectron_weights(tmp_path)
    args = ["--images_dir", str(d), "--arch", "maskrcnn", "--tiny_detectron",
            "--grid_size", "2", "--image_size", size, "--batch_size", "2",
            "--weights", w]
    jmain(args + ["--out", str(tmp_path / "j.h5")])
    tmain(args + ["--out", str(tmp_path / "t.h5"), "--device", "cpu"])
    j, t = read_h5(tmp_path / "j.h5"), read_h5(tmp_path / "t.h5")
    assert sorted(t) == sorted(j) == [f"im{i}" for i in range(len(shapes))]
    for k in j:
        assert t[k]["features"].shape == (2, 2, 24)
        assert_features_close(t[k]["features"], j[k]["features"])


def test_extract_features_resnet50_matches_the_jax_cli(tmp_path):
    """--arch resnet50 at --image_size 64 (a 2x2 layer4 grid) from one
    torchvision-layout .pth through both CLIs' --weights."""
    from xlxmert_tpu.cli.extract_features import main as jmain
    from xlxmert_tpu_torch.cli.extract_features import main as tmain

    d = images_dir(tmp_path, [(50, 70), (64, 64), (80, 40)])
    w = tmp_path / "resnet50.pth"
    torch.save(_torchvision_resnet50_state_dict(), str(w))
    args = ["--images_dir", str(d), "--arch", "resnet50", "--grid_size",
            "2", "--image_size", "64", "--batch_size", "2", "--weights",
            str(w)]
    jmain(args + ["--out", str(tmp_path / "j.h5")])
    tmain(args + ["--out", str(tmp_path / "t.h5"), "--device", "cpu"])
    j, t = read_h5(tmp_path / "j.h5"), read_h5(tmp_path / "t.h5")
    assert sorted(t) == sorted(j) == ["im0", "im1", "im2"]
    for k in j:
        assert t[k]["features"].shape == (2, 2, 2048)
        assert_features_close(t[k]["features"], j[k]["features"])


def test_extract_bbox_features_matches_the_jax_cli(tmp_path):
    """--tiny_detectron with the same weights: the same groups (features,
    obj_id, boxes in original coordinates, img_w, img_h) and shapes; the
    same kept classes, boxes and features within 1e-4 of their largest
    value (the model tests' bar)."""
    from xlxmert_tpu.cli.extract_bbox_features import main as jmain
    from xlxmert_tpu_torch.cli.extract_bbox_features import main as tmain

    d = images_dir(tmp_path, [(40, 56), (56, 40), (48, 48)])
    args = ["--images_dir", str(d), "--tiny_detectron", "--num_features",
            "8", "--n_classes", "9", "--proposals", "24", "--batch_size",
            "2", "--min_size", "64", "--max_size", "96", "--weights",
            detectron_weights(tmp_path, n_classes=9)]
    jmain(args + ["--out", str(tmp_path / "j.h5")])
    tmain(args + ["--out", str(tmp_path / "t.h5"), "--device", "cpu"])
    j, t = read_h5(tmp_path / "j.h5"), read_h5(tmp_path / "t.h5")
    assert sorted(t) == sorted(j) == ["im0", "im1", "im2"]
    for k in j:
        assert sorted(t[k]) == sorted(j[k]) == [
            "boxes", "features", "img_h", "img_w", "obj_id"]
        assert t[k]["features"].shape == (8, 24)
        for n in ("obj_id", "img_w", "img_h"):
            np.testing.assert_array_equal(t[k][n], j[k][n])
        assert np.abs(t[k]["boxes"] - j[k]["boxes"]).max() <= \
            1e-4 * np.abs(j[k]["boxes"]).max()
        assert_features_close(t[k]["features"], j[k]["features"])
    assert int(t["im0"]["img_w"]) == 56 and int(t["im0"]["img_h"]) == 40


def test_corpora_listings_and_names_equal_jax(tmp_path):
    root = tmp_path / "root"
    for split_dir in ("train2014", "val2014"):
        (root / "images" / split_dir).mkdir(parents=True)
        for i in range(3):
            Image.new("RGB", (8, 8)).save(
                root / "images" / split_dir / f"COCO_{i:012d}.jpg")
    (root / "images" / "sub").mkdir()
    Image.new("RGB", (8, 8)).save(root / "images" / "sub" / "a.jpg")
    (root / "images" / "sub" / "broken.jpg").write_bytes(b"not a jpeg")
    for d in ("train/0", "dev"):
        (root / "images" / d).mkdir(parents=True, exist_ok=True)
        Image.new("RGB", (8, 8)).save(root / "images" / d / "x-img0.png")
    for corpus, split in (("coco", "train"), ("coco", "valid"),
                          ("gqa", None), ("vg", None), ("nlvr2", "train"),
                          ("nlvr2", "valid")):
        assert tcorp.corpus_image_paths(corpus, root, split) == \
            jcorp.corpus_image_paths(corpus, root, split)
    with pytest.raises(SystemExit):
        tcorp.corpus_image_paths("coco", root, "bogus")
    for corpus in tcorp.CORPORA:
        for split in ("train", "valid", "test"):
            for kind in ("grid", "bbox"):
                for kw in ({}, {"grid_size": 4, "imsize": 512},
                           {"n_boxes": 10}):
                    assert tcorp.extractor_h5_name(
                        corpus, split, "maskrcnn", kind, **kw) == \
                        jcorp.extractor_h5_name(corpus, split, "maskrcnn",
                                                kind, **kw)
                    assert tcorp.extractor_output_path(
                        corpus, root, split, "resnet50", kind, **kw) == \
                        jcorp.extractor_output_path(corpus, root, split,
                                                    "resnet50", kind, **kw)
                assert tcorp.catalog_h5_name(corpus, split, "maskrcnn",
                                             kind) == \
                    jcorp.catalog_h5_name(corpus, split, "maskrcnn", kind)
    assert tcorp.LAYOUTS == {k: tcorp.CorpusLayout(**vars(v))
                             for k, v in jcorp.LAYOUTS.items()}


@pytest.mark.parametrize("name", ["run_kmeans", "extract_features",
                                  "extract_bbox_features"])
def test_cli_flags_are_the_jax_clis_plus_device(name, monkeypatch):
    """Every flag of the JAX CLI, with its default and choices, and
    --device (cuda by default)."""
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, argv=None: self)

    def flags(pkg):
        parser = importlib.import_module(f"{pkg}.cli.{name}").parse_args([])
        return {a.option_strings[0]: (a.dest, a.default, a.choices)
                for a in parser._actions if a.option_strings
                and a.dest != "help"}

    jax_flags = flags("xlxmert_tpu")
    port_flags = flags("xlxmert_tpu_torch")
    assert port_flags.pop("--device") == ("device", "cuda", ["cuda", "cpu"])
    assert port_flags == jax_flags
