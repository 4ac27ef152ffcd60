"""Device-resident image-feature table for serving (port of
xlxmert_tpu/serving/feature_cache.py).

The catalog's grid features live on the card as one (N, V, D) bf16
table; a query ships only its token ids and an image index, and the
features are gathered on the device with `index_select`. Larger
catalogs shard the image axis over a mesh axis (`build(..., mesh=)`, as
the JAX package shards it over its data axis): each rank holds a block
of rows (pad rows repeat the last image when the catalog does not
divide), and `lookup` with the cache's `shard` gathers the rows the rank
owns, zeros the others and sums the ranks' (B, V, D) parts in fp32, an
exact sum, so every rank gets the unsharded table's rows bit for bit.

Usage:
    cache = FeatureCache.build(reader, img_ids)   # host -> device
    idx   = cache.indices(batch_img_ids)          # host-side dict
    feats = FeatureCache.lookup(cache.table, idx_on_device, cache.shard)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from xlxmert_tpu_torch.utils.device import resolve_device


class FeatureCache:
    """Maps img_id -> row of a device-resident (N, V, D) feature table."""

    def __init__(self, table: torch.Tensor, index: Dict[str, int],
                 shard: Optional[Tuple[int, object]] = None):
        self.table = table
        self.index = index
        # (first row held here, the group the rows are spread over)
        self.shard = shard

    @classmethod
    def build(cls, reader, img_ids: Sequence[str], device="cuda",
              mesh=None, shard_axis: str = "data") -> "FeatureCache":
        """Load the features of `img_ids` from a GridFeatureReader-like
        object (`.get(img_id) -> (g, g, D)`) into one bf16 table on
        `device`, or with `mesh` this rank's block of its rows, the image
        axis split over `shard_axis`. Rows are cast as they are staged,
        so the host holds one bf16 copy of the catalog."""
        dev = resolve_device(device)
        img_ids = [str(i) for i in img_ids]
        if not img_ids:
            raise ValueError("FeatureCache.build: empty img_ids — nothing "
                             "to cache (does the query set reference any "
                             "images?)")
        first = np.asarray(reader.get(img_ids[0]), np.float32)
        v = first.shape[0] * first.shape[1]
        host = torch.empty((len(img_ids), v, first.shape[-1]),
                           dtype=torch.bfloat16)
        host[0] = torch.from_numpy(first.reshape(v, -1))
        for j, i in enumerate(img_ids[1:], start=1):
            host[j] = torch.from_numpy(
                np.asarray(reader.get(i), np.float32).reshape(v, -1))
        index = {i: j for j, i in enumerate(img_ids)}
        if mesh is None or mesh.size(shard_axis) == 1:
            return cls(host.to(dev), index)
        n_shards, k = mesh.size(shard_axis), mesh.index(shard_axis)
        n = len(img_ids)
        rows = -(-n // n_shards)
        padded = torch.cat([host, host[-1:].expand(rows * n_shards - n,
                                                   *host.shape[1:])])
        return cls(padded[k * rows:(k + 1) * rows].to(dev), index,
                   (k * rows, mesh.group(shard_axis)))

    def indices(self, img_ids: Sequence[str]) -> np.ndarray:
        """Host-side id -> row lookup for one batch."""
        return np.asarray([self.index[str(i)] for i in img_ids], np.int64)

    @staticmethod
    def lookup(table: torch.Tensor, idx: torch.Tensor,
               shard: Optional[Tuple[int, object]] = None) -> torch.Tensor:
        """On-device gather: (N, V, D) table + (B,) indices -> (B, V, D).
        With `shard` (a sharded cache's), a collective of the shard
        group: every rank gets the full (B, V, D)."""
        if shard is None:
            return table.index_select(0, idx)
        from xlxmert_tpu_torch.parallel.mesh import all_reduce

        first, group = shard
        local = idx - first
        own = (local >= 0) & (local < table.shape[0])
        rows = table.index_select(0, local.clamp(0, table.shape[0] - 1))
        part = torch.where(own[:, None, None], rows.float(),
                           torch.zeros((), device=rows.device))
        return all_reduce(part, group).to(table.dtype)

    @property
    def nbytes(self) -> int:
        return self.table.numel() * self.table.element_size()
