"""Host-side input: json files and grid-feature HDF5 (port of the parts
of xlxmert_tpu/data/io.py the serving path reads).

File contract: `<encoder>_<split>_grid<g>.h5` holds
f[img_id]['features'] = (g, g, 2048). `h5py` is imported only when a
reader is opened.
"""
from __future__ import annotations

import json
import threading

import numpy as np


def load_json(path) -> object:
    with open(path) as f:
        return json.load(f)


class GridFeatureReader:
    """Read-through random access to `f[img_id]['features']` grid
    features (the feature table keeps the only copy). Thread-safe."""

    def __init__(self, path):
        import h5py

        self.path = str(path)
        self._f = h5py.File(self.path, "r")
        self._lock = threading.Lock()

    def __contains__(self, img_id) -> bool:
        return str(img_id) in self._f

    def get(self, img_id) -> np.ndarray:
        with self._lock:
            return np.asarray(self._f[str(img_id)]["features"], np.float32)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
