"""Host-side input: json files, grid-feature HDF5 and a prefetching
loader (port of the parts of xlxmert_tpu/data/io.py that serving and
fine-tuning read).

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


class PrefetchLoader:
    """Wrap a batch-producing iterable with a background prefetch thread
    (the torch DataLoader worker's role for one training process). An
    error in the worker is re-raised on the consumer's thread: it never
    looks like the end of the epoch."""

    def __init__(self, it_factory, depth: int = 4):
        self.it_factory = it_factory
        self.depth = depth

    def __iter__(self):
        import queue

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        err: list = []

        def worker():
            try:
                for item in self.it_factory():
                    q.put(item)
            except BaseException as e:  # re-raised on the consumer thread
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                break
            yield item
