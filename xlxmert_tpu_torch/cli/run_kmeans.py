"""Visual-vocabulary build CLI (port of xlxmert_tpu/cli/run_kmeans.py; the
faiss-free run_kmeans of the reference, feature_extraction/
run_kmeans.py:43-172).

    python -m xlxmert_tpu_torch.cli.run_kmeans \\
        --src_h5 data/mscoco_imgfeat/maskrcnn_train_grid8.h5 \\
        --assign_h5 data/mscoco_imgfeat/maskrcnn_valid_grid8.h5 \\
        --out_dir data/cluster_centroids --n_centroids 10000 --n_iter 20 \\
        [--device cuda]

The JAX CLI's flags, plus --device (cuda, the default, or cpu). Writes
the centroids as `vocab/kmeans.centroid_filename` under --out_dir, and
for each h5 a pickle {img_id: (g*g,) int64 cluster ids} under
--cluster_dir, named as cli/pretrain's default route reads it.
"""
from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src_h5", required=True,
                   help="grid-feature h5 to train centroids on")
    p.add_argument("--assign_h5", nargs="*", default=[],
                   help="additional h5s to assign cluster ids for")
    p.add_argument("--out_dir", default="data/cluster_centroids")
    p.add_argument("--cluster_dir", default="data/cluster_ids")
    p.add_argument("--n_centroids", type=int, default=10000)
    p.add_argument("--n_iter", type=int, default=20)
    p.add_argument("--encoder", default="maskrcnn")
    p.add_argument("--cluster_src", default="mscoco_train")
    p.add_argument("--grid_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_images", type=int, default=-1,
                   help="subsample training images (RAM bound)")
    p.add_argument("--chunk", type=int, default=0,
                   help="rows per distance tile (0 = auto: chunked once "
                   "the (N, K) matrix would exceed 1 GiB)")
    p.add_argument("--store_dtype", default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="device dtype for the data matrix; bfloat16 halves "
                   "the memory of the production-scale build (distances "
                   "still accumulate in fp32)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def load_h5_matrix(path, grid_size, max_images=-1):
    """h5 -> ((N*g*g, D) matrix, image ids) (run_kmeans.py:20-40)."""
    import h5py

    with h5py.File(path, "r") as f:
        keys = list(f.keys())
        if max_images > 0:
            keys = keys[:max_images]
        feats = [np.asarray(f[k]["features"], np.float32).reshape(
            grid_size * grid_size, -1) for k in keys]
    return np.concatenate(feats), keys


def cluster_pkl_name(h5_path, encoder: str, n_centroids: int, n_iter: int,
                     d: int, grid_size: int) -> str:
    """The pickle's name: the split tag is the h5 stem without the
    encoder prefix and the grid suffix (maskrcnn_train_grid8 -> train),
    as cli/pretrain's default route expects ({encoder}_{split}_img_id_
    to_cluster_id_..., reference naming lxmert_data.py:163-177)."""
    tag = Path(h5_path).stem
    if tag.startswith(f"{encoder}_"):
        tag = tag[len(encoder) + 1:]
    suffix = f"_grid{grid_size}"
    if tag.endswith(suffix):
        tag = tag[: -len(suffix)]
    return (f"{encoder}_{tag}_img_id_to_cluster_id_{n_centroids}"
            f"_iter{n_iter}_d{d}_grid{grid_size}.pkl")


def assign_h5(h5_path, centroids, grid_size: int, device) -> dict:
    """{img_id: (g*g,) int64 cluster ids} of every image of an h5, 4,096
    images at a time."""
    import h5py

    from xlxmert_tpu_torch.vocab.kmeans import assign

    d = centroids.shape[1]
    mapping = {}
    with h5py.File(h5_path, "r") as f:
        keys = list(f.keys())
        for s in range(0, len(keys), 4096):
            chunk_keys = keys[s:s + 4096]
            feats = np.stack([
                np.asarray(f[k]["features"], np.float32).reshape(
                    grid_size ** 2, -1) for k in chunk_keys])
            ids = assign(feats.reshape(-1, d), centroids,
                         device=device).reshape(len(chunk_keys), -1)
            for k, row in zip(chunk_keys, ids):
                mapping[k] = row.astype(np.int64)
    return mapping


def main(argv=None):
    ns = parse_args(argv)

    from xlxmert_tpu_torch.utils.device import resolve_device
    from xlxmert_tpu_torch.vocab.kmeans import centroid_filename, kmeans

    dev = resolve_device(ns.device)
    t0 = time.time()
    data, _ = load_h5_matrix(ns.src_h5, ns.grid_size, ns.max_images)
    d = data.shape[1]
    print(f"loaded {data.shape} in {time.time()-t0:.1f}s")

    t0 = time.time()
    centroids, _ = kmeans(data, ns.n_centroids, ns.n_iter, ns.seed,
                          init="random", verbose=True, chunk=ns.chunk,
                          store_dtype=ns.store_dtype, device=dev)
    print(f"kmeans done in {time.time()-t0:.1f}s")

    out_dir = Path(ns.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cname = centroid_filename(ns.encoder, ns.cluster_src, ns.n_centroids,
                              ns.n_iter, d, ns.grid_size)
    np.save(out_dir / cname, centroids)
    print(f"saved {out_dir / cname}")

    cluster_dir = Path(ns.cluster_dir)
    cluster_dir.mkdir(parents=True, exist_ok=True)
    for h5_path in [ns.src_h5] + list(ns.assign_h5):
        mapping = assign_h5(h5_path, centroids, ns.grid_size, dev)
        out = cluster_dir / cluster_pkl_name(
            h5_path, ns.encoder, ns.n_centroids, ns.n_iter, d, ns.grid_size)
        with open(out, "wb") as fo:
            pickle.dump(mapping, fo)
        print(f"saved {out} ({len(mapping)} images)")


if __name__ == "__main__":
    main()
