"""Checkpoint reading (port of xlxmert_tpu/core/checkpoint.py's
load_any_checkpoint).

Two formats: the reference's flax msgpack pytrees (`.msgpack`, fp32 or
bf16 numpy leaves) and torch `.pth`/`.pt`/`.bin` state_dicts, converted
to the flax layout by core/convert.py. The msgpack decoder reads flax's
encoding without flax: arrays are msgpack ext type 1 holding
(shape, dtype name, bytes), numpy scalars ext type 3. (Flax also
chunks arrays above 1 GiB and encodes complex numbers; no LXMERT
checkpoint holds either.) `msgpack` is imported only when such a file
is read.
"""
from __future__ import annotations

from typing import Any

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


def load_pytree(path: str) -> Any:
    """Decode a flax msgpack checkpoint into nested dicts of numpy."""
    try:
        import msgpack
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} needs the `msgpack` package, which is not "
            "installed; convert the checkpoint to a torch .pth or install "
            "msgpack") from e

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
