"""Device-resident image-feature table for serving (port of
xlxmert_tpu/serving/feature_cache.py).

The catalog's grid features live on the card as one (N, V, D) bf16
table; a query ships only its token ids and an image index, and the
features are gathered on the device with `index_select`. Sharding the
table over several cards is not ported yet.

Usage:
    cache = FeatureCache.build(reader, img_ids)   # host -> device
    idx   = cache.indices(batch_img_ids)          # host-side dict
    feats = FeatureCache.lookup(cache.table, idx_on_device)
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from xlxmert_tpu_torch.utils.device import resolve_device


class FeatureCache:
    """Maps img_id -> row of a device-resident (N, V, D) feature table."""

    def __init__(self, table: torch.Tensor, index: Dict[str, int]):
        self.table = table
        self.index = index

    @classmethod
    def build(cls, reader, img_ids: Sequence[str],
              device="cuda") -> "FeatureCache":
        """Load the features of `img_ids` from a GridFeatureReader-like
        object (`.get(img_id) -> (g, g, D)`) into one bf16 table on
        `device`. Rows are cast as they are staged, so the host holds one
        bf16 copy of the catalog."""
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
        return cls(host.to(dev), {i: j for j, i in enumerate(img_ids)})

    def indices(self, img_ids: Sequence[str]) -> np.ndarray:
        """Host-side id -> row lookup for one batch."""
        return np.asarray([self.index[str(i)] for i in img_ids], np.int64)

    @staticmethod
    def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """On-device gather: (N, V, D) table + (B,) indices -> (B, V, D)."""
        return table.index_select(0, idx)

    @property
    def nbytes(self) -> int:
        return self.table.numel() * self.table.element_size()
