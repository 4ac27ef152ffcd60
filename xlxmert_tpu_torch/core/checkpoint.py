"""Checkpoints (port of xlxmert_tpu/core/checkpoint.py's save_pytree,
load_pytree, merge_params and load_any_checkpoint).

Two formats: the reference's flax msgpack pytrees (`.msgpack`, fp32 or
bf16 numpy leaves) and torch `.pth`/`.pt`/`.bin` state_dicts, converted
to the flax layout by core/convert.py. The msgpack codec is flax's,
without flax: arrays are msgpack ext type 1 holding (shape, dtype name,
bytes), numpy scalars ext type 3, dict keys in sorted order (flax maps
the tree through jax.tree_util first), so `save_pytree` writes the
bytes the JAX package's `save_pytree` writes for the same tree. (Flax
also chunks arrays above 1 GiB and encodes complex numbers; no LXMERT
checkpoint holds either.) A trainer saves a model as
`save_pytree(convert_torch_state_dict(model.state_dict()), path)`, so
its files are the JAX package's. `msgpack` is imported only when such a
file is read or written.
"""
from __future__ import annotations

import os
from typing import Any, List, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        import torch

        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _import_msgpack(path: str):
    try:
        import msgpack
    except ImportError as e:
        raise RuntimeError(
            f"{path} is a flax msgpack checkpoint, which needs the `msgpack` "
            "package; it is not installed") from e
    return msgpack


def _ndarray_to_bytes(msgpack, arr: np.ndarray) -> bytes:
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _sorted_tree(tree: Any) -> Any:
    """Nested dicts with keys sorted (and made str) at every level, numpy
    leaves, as flax's serializer sees the tree."""
    if isinstance(tree, dict):
        return {str(k): _sorted_tree(tree[k]) for k in sorted(tree, key=str)}
    return np.asarray(tree) if not isinstance(tree, np.generic) else tree


def save_pytree(tree: Any, path: str) -> None:
    """Write `tree` (nested dicts of numpy arrays) as a flax msgpack
    checkpoint, atomically: to `path + '.tmp'`, then os.replace, so a run
    killed mid-save never leaves a truncated file."""
    msgpack = _import_msgpack(path)

    def ext(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(msgpack, x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(_EXT_NPSCALAR,
                                   _ndarray_to_bytes(msgpack, np.asarray(x)))
        return x

    data = msgpack.packb(_sorted_tree(tree), default=ext, strict_types=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def merge_params(target: Any, loaded: Any
                 ) -> Tuple[Any, List[str], List[str]]:
    """Overlay `loaded` onto `target` where paths match: strict=False
    checkpoint loading (the reference loads every checkpoint this way).
    A matched leaf of another shape raises (a different model config).
    Returns (merged, missing_paths, unexpected_paths)."""
    missing, unexpected = [], []

    def walk(t, l, prefix):
        if not isinstance(t, dict):
            ts, ls = getattr(t, "shape", None), getattr(l, "shape", None)
            if ts is not None and ls is not None and tuple(ts) != tuple(ls):
                raise ValueError(
                    f"checkpoint shape mismatch at {'/'.join(prefix)}: "
                    f"loaded {tuple(ls)} vs model {tuple(ts)} "
                    "(different model config?)")
            return l
        out = {}
        for k, v in t.items():
            if isinstance(l, dict) and k in l:
                out[k] = walk(v, l[k], prefix + (k,))
            else:
                missing.append("/".join(prefix + (k,)))
                out[k] = v
        if isinstance(l, dict):
            unexpected.extend("/".join(prefix + (k,)) for k in l
                              if k not in t)
        return out

    return walk(target, loaded, ()), missing, unexpected


def load_pytree(path: str) -> Any:
    """Decode a flax msgpack checkpoint into nested dicts of numpy."""
    msgpack = _import_msgpack(path)

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        raise ValueError(f"{path}: unsupported msgpack ext type {code}")

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def load_any_checkpoint(path: str) -> Any:
    """Load a flax msgpack pytree or a torch .pth (converted). A
    full-state checkpoint ({params, opt_state, step}) is unwrapped to its
    params."""
    if path.endswith((".pth", ".pt", ".bin")):
        from xlxmert_tpu_torch.core.convert import load_torch_checkpoint

        return load_torch_checkpoint(path)
    tree = load_pytree(path)
    if isinstance(tree, dict) and {"params", "opt_state", "step"} <= set(
            tree):
        return tree["params"]
    return tree
