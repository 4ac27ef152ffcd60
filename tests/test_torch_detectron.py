"""The port's Detectron graph (xlxmert_tpu_torch/models/detectron.py, on
the CPU, fp32) against the JAX package's (xlxmert_tpu/models/detectron.py)
at tiny_detectron_config with random FrozenBN statistics, on the same
seeded numpy inputs and the same param tree: ROIAlign, the FPN level
assignment, grid boxes, the grid extractor, a maskrcnn-benchmark state
dict through both packages, the host-side preprocessing, the anchors,
the box decoding and clipping, and the detector stage by stage on JAX's
own intermediate outputs."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlxmert_tpu.models import detectron as J
from xlxmert_tpu_torch.models import detectron as D

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores")

CFG = D.tiny_detectron_config()
JCFG = J.tiny_detectron_config()
N_CLASSES = 9


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def world():
    """A detector's random tree, a padded batch of two images (one
    smaller than the canvas) and JAX's grid features and detector
    outputs, with the detector's backbone and RPN head outputs
    (captured intermediates)."""
    tree = D.random_params(CFG, 0, n_classes=N_CLASSES)
    rng = np.random.RandomState(0)
    images = np.zeros((2, 64, 96, 3), np.float32)
    images[0] = rng.randn(64, 96, 3) * 50
    images[1, :48, :64] = rng.randn(48, 64, 3) * 50
    sizes = np.array([[64, 96], [48, 64]], np.int32)
    grid_tree = {k: tree[k] for k in ("backbone", "box_head")}
    x, s = jnp.asarray(images), jnp.asarray(sizes)
    grid = np.asarray(jax.jit(J.DetectronGridExtractor(JCFG, grid_size=2)
                              .apply)({"params": grid_tree}, x, s))
    det = J.DetectronDetector(JCFG, n_classes=N_CLASSES, pre_nms_top_n=50,
                              post_nms_top_n=20, fpn_post_nms_top_n=20)
    out, state = jax.jit(lambda v, x, s: det.apply(
        v, x, s, capture_intermediates=True, mutable=["intermediates"]))(
            {"params": tree}, x, s)
    inter = jax.tree.map(np.asarray, state["intermediates"])
    logits, deltas = inter["rpn_head"]["__call__"][0]
    return {"tree": tree, "grid_tree": grid_tree, "images": images,
            "sizes": sizes, "grid": grid,
            "fpn": inter["backbone"]["__call__"][0], "logits": logits,
            "deltas": deltas, "det": jax.tree.map(np.asarray, out)}


def rois_of(rng, n, h, w):
    """Rois inside, across the edges of and outside an (h, w) image, and
    some thinner than a pixel."""
    x0 = rng.uniform(-0.3 * w, w, n)
    y0 = rng.uniform(-0.3 * h, h, n)
    bw = rng.uniform(0.2, 0.8 * w, n)
    bh = rng.uniform(0.2, 0.8 * h, n)
    return np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)


def test_roi_align_matches_jax():
    rng = np.random.RandomState(1)
    feat = rng.randn(13, 17, 5).astype(np.float32)
    rois = rois_of(rng, 40, 52, 68)
    jitted = jax.jit(J.roi_align, static_argnums=(2, 3, 4))
    for scale, res, n in ((0.25, 7, 2), (0.125, 3, 1), (1.0, 2, 3)):
        ref = np.asarray(jitted(jnp.asarray(feat), jnp.asarray(rois),
                                scale, res, n))
        got = D.roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                          scale, res, n).numpy()
        assert got.shape == ref.shape == (40, res, res, 5)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_multilevel_roi_align_and_level_assignment_match_jax():
    rng = np.random.RandomState(2)
    feats = [rng.randn(64 // 2 ** l, 96 // 2 ** l, 6).astype(np.float32)
             for l in range(2, 6)]
    rois = np.concatenate([rois_of(rng, 30, 256, 384),
                           np.array([[0, 0, 224, 224], [0, 0, 111.9, 112],
                                     [5, 5, 5, 5], [10, 0, 600, 500]],
                                    np.float32)])
    lv_ref = np.asarray(J.fpn_level_assignment(jnp.asarray(rois)))
    lv = D.fpn_level_assignment(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(lv, lv_ref)
    assert set(lv.tolist()) >= {0, 1, 2, 3}
    ref = np.asarray(jax.jit(J.multilevel_roi_align)(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    got = D.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                 torch.from_numpy(rois)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_grid_boxes_match_jax():
    for h, w, g in ((64, 96, 2), (800, 1333, 8), (37, 51, 4)):
        np.testing.assert_array_equal(
            D.grid_boxes(h, w, g).numpy(), np.asarray(J.grid_boxes(h, w, g)))
    both = D.grid_boxes(torch.tensor([64, 37]), torch.tensor([96, 51]), 2)
    np.testing.assert_array_equal(both[1].numpy(),
                                  np.asarray(J.grid_boxes(37, 51, 2)))


def test_grid_extractor_matches_jax(world):
    """fp32, the same tree: cosine >= 0.99999, max |d| <= 1e-4 max |ref|."""
    m = D.load_params(D.DetectronGridExtractor(CFG, grid_size=2),
                      world["grid_tree"]).eval()
    with torch.inference_mode():
        got = m(torch.from_numpy(world["images"]),
                torch.from_numpy(world["sizes"])).numpy()
    ref = world["grid"]
    assert got.shape == ref.shape == (2, 4, CFG.mlp_dim)
    assert cosine(got, ref) >= 0.99999
    assert max_rel(got, ref) <= 1e-4


def test_forward_runs_with_autograd_on(world):
    """The convolutions' parameters are frozen, so FrozenBN's in-place
    addcmul is legal outside inference mode: the plain forward gives the
    inference-mode features."""
    m = D.load_params(D.DetectronGridExtractor(CFG, grid_size=2),
                      world["grid_tree"]).eval()
    assert not any(p.requires_grad for p in m.backbone.parameters())
    x, s = torch.from_numpy(world["images"]), torch.from_numpy(
        world["sizes"])
    got = m(x, s)
    with torch.inference_mode():
        ref = m(x, s)
    assert torch.equal(got.detach(), ref)


def test_state_dict_loads_through_both_packages(world):
    """The maskrcnn-benchmark names (under "model", with DDP prefixes)
    that JAX's convert_detectron_state_dict reads: it gives back the same
    tree, and the port's loader the same features."""
    sd = D.params_to_state_dict(world["tree"], CFG)
    assert "backbone.body.layer1.0.downsample.1.running_var" in sd
    assert "roi_heads.box.predictor.cls_score.weight" in sd
    back = J.convert_detectron_state_dict(
        {f"module.{k}": v.numpy() for k, v in sd.items()}, JCFG)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(world["tree"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
    m = D.DetectronGridExtractor(CFG, grid_size=2)
    D.load_detectron_state_dict(
        m, {"model": {f"module.{k}": v for k, v in sd.items()}})
    with torch.inference_mode():
        got = m.eval()(torch.from_numpy(world["images"]),
                       torch.from_numpy(world["sizes"])).numpy()
    assert cosine(got, world["grid"]) >= 0.99999
    assert max_rel(got, world["grid"]) <= 1e-4
    with pytest.raises(KeyError, match="lacks"):
        D.load_detectron_state_dict(
            m, {k: v for k, v in sd.items() if "fc7" not in k})


def test_preprocessing_matches_jax():
    for args in ((480, 640), (640, 480), (300, 2000), (100, 100, 256),
                 (50, 40)):
        assert D.detectron_resize_shape(*args) == \
            J.detectron_resize_shape(*args)
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (30, 41, 3)).astype(np.uint8)
    for target in ((64, 96), (30, 41), (17, 23)):
        np.testing.assert_allclose(D.preprocess_image(img, target),
                                   J.preprocess_image(img, target),
                                   atol=1e-5, rtol=1e-5)
    gray = rng.randint(0, 255, (20, 20)).astype(np.uint8)
    np.testing.assert_allclose(D.preprocess_image(gray, (32, 32)),
                               J.preprocess_image(gray, (32, 32)),
                               atol=1e-5, rtol=1e-5)


def test_anchors_decode_and_clip_match_jax():
    for stride, size in zip(D.ANCHOR_STRIDES, D.ANCHOR_SIZES):
        np.testing.assert_array_equal(
            D.level_anchors(stride, size, 3, 5),
            J.level_anchors(stride, size, 3, 5))
    rng = np.random.RandomState(4)
    anchors = D.level_anchors(8, 64, 6, 7)
    deltas = (rng.randn(len(anchors), 4) * 2).astype(np.float32)
    deltas[:5, 2:] = 9.0          # past BBOX_XFORM_CLIP
    ref = np.asarray(J.decode_boxes(jnp.asarray(anchors),
                                    jnp.asarray(deltas)))
    got = D.decode_boxes(torch.from_numpy(anchors),
                         torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        D.clip_boxes(torch.from_numpy(got), 40.0, 50.0).numpy(),
        np.asarray(J.clip_boxes(jnp.asarray(got), 40.0, 50.0)), atol=1e-5)


def test_detector_stage_by_stage_on_jax_intermediates(world):
    """Each stage fed JAX's own inputs to it: the backbone (FPN levels),
    the RPN head (objectness and deltas), the proposal stage (the same
    proposals and scores), the box head (class scores, fc6, fc7); and
    the whole detector."""
    m = D.load_params(D.DetectronDetector(
        CFG, n_classes=N_CLASSES, pre_nms_top_n=50, post_nms_top_n=20,
        fpn_post_nms_top_n=20), world["tree"]).eval()
    x = torch.from_numpy(world["images"])
    s = torch.from_numpy(world["sizes"])
    with torch.inference_mode():
        fpn = m.backbone(x)
        for got, ref in zip(fpn, world["fpn"]):
            assert max_rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
        jfpn = [nchw(f) for f in world["fpn"]]
        logits, deltas = m.rpn["head"](jfpn)
        for got, ref in zip(logits + deltas,
                            world["logits"] + world["deltas"]):
            assert max_rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
        props, cls, feats, obj = world["det"]
        prop = m.propose([nchw(t) for t in world["logits"]],
                         [nchw(t) for t in world["deltas"]], s)
        np.testing.assert_array_equal(prop["scores"].numpy(), obj)
        assert max_rel(prop["boxes"].numpy(), props) <= 1e-5
        assert np.isfinite(obj).all()
        c, f = m.box_head(jfpn, torch.from_numpy(np.array(props)))
        assert max_rel(c.numpy(), cls) <= 1e-5
        for k in ("fc6", "fc7"):
            assert max_rel(f[k].numpy(), feats[k]) <= 1e-5
        p2, c2, f2, o2 = m(x, s)
    assert p2.shape == (2, 20, 4) and c2.shape == (2, 20, N_CLASSES)
    # end to end the port's own objectness differs from JAX's in the
    # last bits: the same proposals, their scores within 1e-5
    np.testing.assert_allclose(o2.numpy(), obj, rtol=1e-5)
    assert max_rel(p2.numpy(), props) <= 1e-5
    assert cosine(f2["fc6"].numpy(), feats["fc6"]) >= 0.99999
    # the second image's proposals are clipped to its valid 48 x 64
    assert p2[1, :, 3].max() <= 47 and p2[1, :, 2].max() <= 63
