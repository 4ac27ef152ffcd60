"""k-means visual vocabulary (port of xlxmert_tpu/vocab/kmeans.py: the
faiss-free build of the reference's feature_extraction/run_kmeans.py,
faiss.Kmeans(2048, 10000, niter=20) on (N*64, 2048) grid features, then
1-NN assignment).

Both phases are an (n, D) x (D, K) product plus an argmin: distances as
||c||^2 - 2 x.c in fp32 (`torch.matmul`, TF32 off by PyTorch's default),
the per-cluster sums and counts as fp32 `index_add_` (atomics on the
card, so their order is not fixed). Empty clusters keep their centroid.
`lloyd_step_chunked` never holds more than a (chunk, K) distance tile,
which is what lets the production 10,000-centroid build fit one card.
Initial centroids come from `np.random.RandomState(seed)` exactly as in
the JAX package, so both start from the same centroids.

The entry points (`assign`, `kmeans`) run on the card unless the caller
passes device="cpu"; `lloyd_step` and `lloyd_step_chunked` run where
their tensors lie. `data` may be a numpy array or a tensor.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from xlxmert_tpu_torch.utils.device import resolve_device

_DTYPES = {None: None, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def _assign_chunk(x: torch.Tensor, centroids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, D) -> (n,) nearest-centroid ids (int32) and (n,) squared
    distances: ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2, the x.c term the
    product."""
    x32 = x.float()
    c32 = centroids.float()
    d = torch.matmul(x32, c32.t())            # (n, K)
    c_norm = (c32 * c32).sum(dim=1)
    d.mul_(-2.0).add_(c_norm)                 # c_norm - 2 x.c, exactly
    ids = torch.argmin(d, dim=1)
    x_norm = (x32 * x32).sum(dim=1)
    dist = d.gather(1, ids[:, None])[:, 0] + x_norm
    return ids.int(), torch.clamp(dist, min=0.0)


def assign(x, centroids, chunk: int = 65536, device="cuda") -> np.ndarray:
    """Nearest-centroid ids (IndexFlatL2 1-NN, run_kmeans.py:123-143),
    chunked over rows. x: numpy or a tensor (a chunk is moved to
    `device`); returns a host int32 array."""
    dev = resolve_device(device)
    c = torch.as_tensor(centroids).to(dev)
    xt = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    out = []
    for i in range(0, xt.shape[0], chunk):
        ids, _ = _assign_chunk(xt[i:i + chunk].to(dev), c)
        out.append(ids.cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def _update(sums: torch.Tensor, counts: torch.Tensor,
            centroids: torch.Tensor) -> torch.Tensor:
    """Per-cluster means; an empty cluster keeps its centroid."""
    new = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, new, centroids.float())


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over all of x: assignment and the per-cluster
    mean update. Returns (new_centroids, inertia)."""
    ids, dist = _assign_chunk(x, centroids)
    idx = ids.long()
    sums = torch.zeros(k, x.shape[1], dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x.float())
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx, torch.ones(x.shape[0], device=x.device))
    return _update(sums, counts, centroids), dist.mean()


def lloyd_step_chunked(x: torch.Tensor, weights: torch.Tensor,
                       centroids: torch.Tensor, k: int, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Lloyd iteration that never holds more than a (chunk, K)
    distance tile: a loop over row chunks accumulating fp32 per-cluster
    sums and counts. `x` is padded to a multiple of `chunk`; `weights`
    (n,) is 1.0 for real rows and 0.0 for padding. On the real rows it
    equals `lloyd_step` but for the order of the fp32 sums."""
    n, d = x.shape
    if n % chunk:
        raise ValueError(f"x has {n} rows, not a multiple of chunk {chunk}")
    sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        xc, wc = x[s:s + chunk], weights[s:s + chunk].float()
        ids, dist = _assign_chunk(xc, centroids)
        idx = ids.long()
        sums.index_add_(0, idx, xc.float() * wc[:, None])
        counts.index_add_(0, idx, wc)
        tot = tot + (dist * wc).sum()
    return (_update(sums, counts, centroids),
            tot / torch.clamp(weights.float().sum(), min=1.0))


def _kmeanspp_init(data: np.ndarray, k: int, rng: np.random.RandomState
                   ) -> np.ndarray:
    """k-means++ seeding (D^2 sampling) on the host, the JAX package's
    draws. O(k*N*D): for small and medium k; the 10,000-centroid build
    uses random init, as faiss does."""
    n = data.shape[0]
    centers = [data[rng.randint(n)]]
    d2 = ((data - centers[0]) ** 2).sum(axis=1)
    for _ in range(k - 1):
        p = d2 / max(d2.sum(), 1e-12)
        idx = rng.choice(n, p=p)
        centers.append(data[idx])
        d2 = np.minimum(d2, ((data - centers[-1]) ** 2).sum(axis=1))
    return np.stack(centers)


def balanced_chunk(n: int, k: int) -> int:
    """The auto tile: 0 (one-shot) while the (n, K) fp32 distance matrix
    stays under 1 GiB, else balanced tiles of at most 65,536 rows rounded
    up to 256 (N just over one tile would otherwise pad up to ~2x)."""
    if n * k * 4 <= 1 << 30:
        return 0
    n_tiles = -(-n // 65536)
    return -(-(-(-n // n_tiles)) // 256) * 256


def kmeans(data, k: int, n_iter: int = 20, seed: int = 0,
           init: str = "auto", verbose: bool = False, chunk: int = 0,
           store_dtype=None, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Train k-means; returns host arrays (centroids (k, D) fp32, final
    assignments (N,) int32).

    init: "random" = k distinct rows (faiss's default, the production
    k=10,000 build), "++" = k-means++, "auto" = ++ when k <= 256.
    chunk: rows per distance tile; 0 = `balanced_chunk`'s choice, any
    positive value forces the chunked step. store_dtype: the data's type
    on the device (None keeps data's; "bfloat16" halves the memory, the
    distances still in fp32: only the inputs are rounded)."""
    dev = resolve_device(device)
    n = data.shape[0]
    rng = np.random.RandomState(seed)
    if init == "auto":
        init = "++" if k <= 256 else "random"
    if init == "++":
        host = (data.cpu().numpy() if isinstance(data, torch.Tensor)
                else np.asarray(data))
        centroids = torch.from_numpy(np.asarray(
            _kmeanspp_init(host, k, rng), np.float32)).to(dev)
    else:
        init_idx = rng.choice(n, size=k, replace=n < k)
        src = data if isinstance(data, torch.Tensor) else \
            torch.as_tensor(data)
        centroids = src[torch.from_numpy(init_idx).to(src.device)].to(
            dev, torch.float32)
    if chunk == 0:
        chunk = balanced_chunk(n, k)
    x = torch.as_tensor(data).to(dev, dtype=_DTYPES[store_dtype])
    if chunk:
        pad = (-n) % chunk
        if pad:
            x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
        weights = torch.cat([torch.ones(n, device=dev),
                             torch.zeros(pad, device=dev)])
    for i in range(n_iter):
        t0 = time.time()
        if chunk:
            centroids, inertia = lloyd_step_chunked(x, weights, centroids,
                                                    k, chunk)
        else:
            centroids, inertia = lloyd_step(x, centroids, k)
        if verbose:
            print(f"kmeans iter {i}: inertia {float(inertia):.4f} "
                  f"({time.time() - t0:.2f}s)")
    del x
    final = assign(data, centroids, device=dev)
    return centroids.cpu().numpy(), final


def centroid_filename(encoder: str, cluster_src: str, n_centroids: int,
                      n_iter: int, d: int, grid: int) -> str:
    """The reference's centroid file name (lxmert_pretrain.py:72-75,
    main.py:51-56)."""
    return (f"{encoder}_{cluster_src}_centroids{n_centroids}"
            f"_iter{n_iter}_d{d}_grid{grid}.npy")
