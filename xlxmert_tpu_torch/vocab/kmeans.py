"""The visual vocabulary's file naming (port of the part of
xlxmert_tpu/vocab/kmeans.py that pre-training reads). k-means itself
is not ported yet."""
from __future__ import annotations


def centroid_filename(encoder: str, cluster_src: str, n_centroids: int,
                      n_iter: int, d: int, grid: int) -> str:
    """The reference's centroid file name (lxmert_pretrain.py:72-75,
    main.py:51-56)."""
    return (f"{encoder}_{cluster_src}_centroids{n_centroids}"
            f"_iter{n_iter}_d{d}_grid{grid}.npy")
