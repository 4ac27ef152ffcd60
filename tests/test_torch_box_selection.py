"""The port's NMS and bbox-feature selection (xlxmert_tpu_torch/ops/
{nms,box_selection}.py, on the CPU) against the JAX package's on the
same seeded numpy inputs, whose scores hold no near-ties: the same
indices, valid flags, keep masks and kept features, exactly; and the
batched forms (a leading dimension in place of vmap) equal the
per-image ones."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlxmert_tpu.ops import box_selection as jbs
from xlxmert_tpu.ops import nms as jnms
from xlxmert_tpu_torch.ops import box_selection as tbs
from xlxmert_tpu_torch.ops import nms as tnms

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores")


def random_boxes(rng, n, lim=100.0):
    x0 = rng.uniform(0, lim * 0.8, n)
    y0 = rng.uniform(0, lim * 0.8, n)
    w = rng.uniform(5, lim * 0.5, n)
    h = rng.uniform(5, lim * 0.5, n)
    return np.stack([x0, y0, x0 + w, y0 + h], axis=1).astype(np.float32)


def distinct_scores(rng, *shape):
    """Scores whose sorted gaps exceed 1e-4: no near-ties."""
    n = int(np.prod(shape))
    return (rng.permutation(n).reshape(shape) / n + 1e-3).astype(np.float32)


def test_iou_matrix_matches_jax():
    rng = np.random.RandomState(0)
    b = random_boxes(rng, 30)
    b[3] = [5, 5, 5, 9]                       # zero area
    np.testing.assert_allclose(
        tnms.iou_matrix(torch.from_numpy(b)).numpy(),
        np.asarray(jnms.iou_matrix(jnp.asarray(b))), atol=1e-6)


@pytest.mark.parametrize("n,max_out,thr", [(40, 36, 0.5), (12, 20, 0.3),
                                           (60, 10, 0.7)])
def test_nms_matches_jax(n, max_out, thr):
    """The fixed-round contract: max_out slots, valid=False past the
    survivors, their index what argmax gives once all are suppressed."""
    rng = np.random.RandomState(n)
    boxes = random_boxes(rng, n)
    scores = distinct_scores(rng, n)
    ji, jv = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
    ti, tv = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                      max_out)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if n < max_out:
        assert not tv[-1]


def test_batched_class_nms_matches_jax_and_the_per_class_calls():
    rng = np.random.RandomState(5)
    boxes = np.stack([random_boxes(rng, 25) for _ in range(4)])
    scores = distinct_scores(rng, 4, 25)
    ji, jv = jnms.batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    0.5, 12)
    ti, tv = tnms.batched_class_nms(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.5, 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for c in range(4):
        i, v = tnms.nms(torch.from_numpy(boxes[c]),
                        torch.from_numpy(scores[c]), 0.5, 12)
        assert torch.equal(i, ti[c]) and torch.equal(v, tv[c])


def test_multiclass_nms_mask_matches_jax():
    rng = np.random.RandomState(1)
    P, C = 30, 6
    boxes = random_boxes(rng, P)
    scores = distinct_scores(rng, P, C)
    valid = np.ones(P, bool)
    valid[20:] = False
    for v in (None, valid):
        ref = np.asarray(jbs.multiclass_nms_mask(
            jnp.asarray(boxes), jnp.asarray(scores), 0.5,
            None if v is None else jnp.asarray(v)))
        got = tbs.multiclass_nms_mask(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
            None if v is None else torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, ref)


def select_inputs(rng, P=40, C=8, D=10):
    proposals = random_boxes(rng, P) * 1.5
    # logits spread far apart: softmax scores without near-ties
    logits = (rng.permutation(P * C).reshape(P, C) / (P * C) * 12
              ).astype(np.float32)
    feats = rng.randn(P, D).astype(np.float32)
    return proposals, logits, feats


@pytest.mark.parametrize("background,conf", [(False, 0.0), (True, 0.0),
                                             (False, 0.2)])
def test_select_top_features_matches_jax(background, conf):
    rng = np.random.RandomState(2)
    proposals, logits, feats = select_inputs(rng)
    valid = np.ones(len(proposals), bool)
    valid[-5:] = False
    kw = dict(num_features=12, conf_thresh=conf, background=background)
    ref = jax.tree.map(np.asarray, jbs.select_top_features(
        jnp.asarray(proposals), jnp.asarray(logits), jnp.asarray(feats),
        1.5, valid=jnp.asarray(valid), **kw))
    got = tbs.select_top_features(
        torch.from_numpy(proposals), torch.from_numpy(logits),
        torch.from_numpy(feats), 1.5, valid=torch.from_numpy(valid), **kw)
    for k in ("features", "obj_id", "num_boxes"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["cls_prob"].numpy(), ref["cls_prob"],
                               rtol=1e-6)
    np.testing.assert_array_equal(got["features"].numpy(),
                                  feats[got["keep_boxes"].numpy()])


def test_selection_of_a_batch_equals_each_image_alone():
    rng = np.random.RandomState(3)
    per = [select_inputs(rng) for _ in range(3)]
    stack = [torch.from_numpy(np.stack(t)) for t in zip(*per)]
    scales = torch.tensor([1.0, 2.0, 0.5])
    valid = torch.ones(3, 40, dtype=torch.bool)
    valid[1, 30:] = False
    out = tbs.select_top_features(*stack, scales, valid=valid,
                                  num_features=9)
    for b in range(3):
        one = tbs.select_top_features(*(t[b] for t in stack),
                                      float(scales[b]), valid=valid[b],
                                      num_features=9)
        for k, v in one.items():
            assert torch.equal(out[k][b], v), k
    # ties of the top-k go to the lower index, as jax.lax.top_k
    vals, idx = tbs.top_k_lower_index(torch.tensor([1.0, 3.0, 3.0, 2.0,
                                                    3.0]), 4)
    assert idx.tolist() == [1, 2, 4, 3]
