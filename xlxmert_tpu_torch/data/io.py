"""Host-side input: json and pickle files, grid- and bbox-feature HDF5,
cluster maps and a prefetching loader (port of xlxmert_tpu/data/io.py).

File contracts: `<encoder>_<split>_grid<g>.h5` holds
f[img_id]['features'] = (g, g, 2048); the k-means pickle maps img_id to
(g*g,) cluster ids. `h5py` is imported only when a reader is opened.
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


def load_pickle(path) -> object:
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


class BboxFeatureReader:
    """Random access to the bbox extractor's h5 (`maskrcnn_*_boxes36.h5`:
    per image features (n_boxes, 2048), obj_id (n_boxes,), boxes
    (n_boxes, 4) in pixels, img_w, img_h). `get` returns {features,
    obj_id, boxes} with the boxes divided by the image size and clamped
    to [0, 1], as the reference's pre-training loader does
    (lxmert_data.py:310-325). Thread-safe; each decoded image is kept
    after its first read."""

    def __init__(self, path):
        import h5py

        self.path = str(path)
        self._f = h5py.File(self.path, "r")
        self._cache: dict = {}
        self._lock = threading.Lock()

    def __contains__(self, img_id) -> bool:
        return str(img_id) in self._f

    def get(self, img_id) -> dict:
        img_id = str(img_id)
        hit = self._cache.get(img_id)
        if hit is not None:
            return hit
        with self._lock:
            g = self._f[img_id]
            feats = np.asarray(g["features"], np.float32)
            obj_id = np.asarray(g["obj_id"], np.int32)
            boxes = np.array(g["boxes"], np.float32)
            img_w = float(np.asarray(g["img_w"]))
            img_h = float(np.asarray(g["img_h"]))
        boxes[:, (0, 2)] /= img_w
        boxes[:, (1, 3)] /= img_h
        np.clip(boxes, 0.0, 1.0, out=boxes)
        out = {"features": feats, "obj_id": obj_id, "boxes": boxes}
        self._cache[img_id] = out
        return out

    def close(self):
        self._f.close()


class ClusterMap:
    """img_id -> (n_grids,) cluster ids, from the k-means pickle
    ({img_id: (g*g,) int}, run_kmeans.py:153-166)."""

    def __init__(self, path_or_map):
        self.map = (path_or_map if isinstance(path_or_map, dict)
                    else load_pickle(path_or_map))

    def __contains__(self, img_id):
        return img_id in self.map

    def get(self, img_id) -> np.ndarray:
        return np.asarray(self.map[img_id], np.int32).reshape(-1)


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
