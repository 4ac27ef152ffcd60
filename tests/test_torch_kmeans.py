"""The port's k-means (xlxmert_tpu_torch/vocab/kmeans.py, on the CPU)
against the JAX package's (xlxmert_tpu/vocab/kmeans.py) on the same
seeded numpy inputs: one assignment and one Lloyd step under chip_smoke
(l)'s tie-aware bars, the chunked step against the one-shot, whole runs
(both inits, chunked, bf16 storage) on well-separated blobs, and the
centroid file name."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlxmert_tpu.vocab import kmeans as jk
from xlxmert_tpu_torch.vocab import kmeans as tk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores")


def blobs(n_per=400, k=6, d=32, seed=0, spread=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 3
    pts = np.concatenate([centers[i] + rng.randn(n_per, d) * spread
                          for i in range(k)])
    perm = rng.permutation(len(pts))
    return pts[perm].astype(np.float32), np.repeat(np.arange(k), n_per)[perm]


def test_assign_and_lloyd_step_match_jax_within_the_tie_aware_bars():
    """N = 4,096 random rows, K = 64, D = 64 (near-ties are likely at
    random): the ids, the distances of the rows that differ, the
    centroids of clusters whose members agree and the inertia, as
    chip_smoke (l) holds the card to the CPU."""
    rng = np.random.RandomState(0)
    x = rng.randn(4096, 64).astype(np.float32)
    c0 = x[rng.choice(4096, 64, replace=False)]
    ids_j, _ = jk._assign_chunk(jnp.asarray(x), jnp.asarray(c0), 64)
    new_j, inert_j = jk.lloyd_step(jnp.asarray(x), jnp.asarray(c0), 64)
    ids_t = tk.assign(x, c0, device="cpu")
    np.testing.assert_array_equal(ids_t, jk.assign(x, c0))
    new_t, inert_t = tk.lloyd_step(torch.from_numpy(x),
                                   torch.from_numpy(c0), 64)
    chk = chip_smoke.kmeans_agreement(
        x, c0, {"ids": ids_t, "centroids": new_t.numpy(),
                "inertia": float(inert_t)},
        {"ids": np.asarray(ids_j), "centroids": np.asarray(new_j),
         "inertia": float(inert_j)})
    assert chk["failures"] == [], chk
    assert chk["clean_clusters"] >= 60
    # brute force in float64
    ref = np.argmin(((x[:, None].astype(np.float64) - c0[None]) ** 2)
                    .sum(-1), axis=1)
    assert (ids_t == ref).mean() >= chip_smoke.KMEANS_AGREE


def test_kmeans_agreement_reports_what_it_misses():
    """The bars fail where they should: a swapped id far from a tie, a
    moved centroid, an inertia off by 1e-4."""
    rng = np.random.RandomState(1)
    x = rng.randn(2000, 8).astype(np.float32)
    c0 = rng.randn(5, 8).astype(np.float32)
    ids = tk.assign(x, c0, device="cpu")
    new, inert = tk.lloyd_step(torch.from_numpy(x), torch.from_numpy(c0), 5)
    run = {"ids": ids, "centroids": new.numpy(), "inertia": float(inert)}
    assert chip_smoke.kmeans_agreement(x, c0, run, dict(run))[
        "failures"] == []
    far = dict(run, ids=ids.copy())
    far["ids"][:3] = (ids[:3] + 1) % 5
    got = chip_smoke.kmeans_agreement(x, c0, far, run)
    assert len(got["failures"]) == 2   # the share is met, the distances not
    moved = dict(run, centroids=run["centroids"] + 1e-3)
    assert len(chip_smoke.kmeans_agreement(x, c0, moved, run)[
        "failures"]) == 1
    off = dict(run, inertia=run["inertia"] * (1 + 1e-4))
    assert len(chip_smoke.kmeans_agreement(x, c0, off, run)[
        "failures"]) == 1


def test_lloyd_step_chunked_equals_the_one_shot_step():
    """Padding (1,000 rows in tiles of 256) with zero weights, as JAX:
    the same centroids and inertia as the one-shot step, and as JAX's
    chunked step."""
    x, _ = blobs(n_per=250, k=4, d=16, spread=1.0)
    rng = np.random.RandomState(2)
    c0 = x[rng.choice(len(x), 4, replace=False)]
    one, one_in = tk.lloyd_step(torch.from_numpy(x), torch.from_numpy(c0), 4)
    pad = (-len(x)) % 256
    xp = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
    w = np.concatenate([np.ones(len(x), np.float32),
                        np.zeros(pad, np.float32)])
    ch, ch_in = tk.lloyd_step_chunked(torch.from_numpy(xp),
                                      torch.from_numpy(w),
                                      torch.from_numpy(c0), 4, 256)
    np.testing.assert_allclose(ch.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ch_in), float(one_in), rtol=1e-5)
    jc, jin = jk.lloyd_step_chunked(jnp.asarray(xp), jnp.asarray(w),
                                    jnp.asarray(c0), 4, 256)
    np.testing.assert_allclose(ch.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ch_in), float(jin), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tk.lloyd_step_chunked(torch.from_numpy(x), torch.ones(len(x)),
                              torch.from_numpy(c0), 4, 256)


@pytest.mark.parametrize("init,chunk,store", [
    ("++", 0, None), ("random", 0, None), ("random", 512, None),
    ("auto", 384, "bfloat16")])
def test_kmeans_matches_jax_on_blobs(init, chunk, store):
    """Whole runs from the same seed: both packages draw the same initial
    centroids, so the ids are equal and the centroids agree within 1e-5
    relative (the data in bf16 where stored so). Seed 86's random init
    takes one row of each blob (checked here): two in one blob would
    split it, and the rows on that split are near-ties."""
    x, labels = blobs(n_per=400, k=6, d=32, seed=3)
    kw = dict(k=6, n_iter=6, seed=86, init=init, chunk=chunk,
              store_dtype=store)
    if init == "random":
        first = np.random.RandomState(86).choice(len(x), 6, replace=False)
        assert len(set(labels[first])) == 6
    cj, fj = jk.kmeans(x, **kw)
    ct, ft = tk.kmeans(x, device="cpu", **kw)
    np.testing.assert_array_equal(ft, fj)
    scale = np.abs(np.asarray(cj)).max()
    assert np.abs(ct - np.asarray(cj)).max() <= 1e-5 * scale
    for b in range(6):        # every blob recovered
        assert np.bincount(ft[labels == b]).max() == 400


def test_kmeans_takes_a_tensor_and_keeps_empty_clusters():
    x, _ = blobs(n_per=100, k=3, d=8)
    c_np, f_np = tk.kmeans(x, 3, n_iter=3, seed=1, init="random",
                           device="cpu")
    c_t, f_t = tk.kmeans(torch.from_numpy(x), 3, n_iter=3, seed=1,
                         init="random", device="cpu")
    np.testing.assert_array_equal(f_t, f_np)
    np.testing.assert_array_equal(c_t, c_np)
    zeros = torch.zeros(10, 4)
    c0 = torch.tensor([[0.0] * 4, [100.0] * 4])
    new, _ = tk.lloyd_step(zeros, c0, 2)
    assert torch.equal(new[1], c0[1])
    assert tk.balanced_chunk(131072, 10000) == 65536
    assert tk.balanced_chunk(1000, 10) == 0
    assert tk.balanced_chunk(70000, 10000) == 35072


def test_centroid_filename_equals_jax():
    args = ("maskrcnn", "mscoco_train", 10000, 20, 2048, 8)
    assert tk.centroid_filename(*args) == jk.centroid_filename(*args)
