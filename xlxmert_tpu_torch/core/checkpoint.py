"""Checkpoints (port of xlxmert_tpu/core/checkpoint.py): save_pytree,
load_pytree, merge_params, load_any_checkpoint, epoch_ckpt_name,
parse_start_epoch, AsyncCheckpointer, and the full train state of an
exact resume (train_state_to_tree, restore_train_state).

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
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

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


def is_full_state_tree(tree: Any) -> bool:
    """A full train-state checkpoint ({params, opt_state, step}), the
    JAX package's Epoch%02d_FULL.msgpack."""
    return isinstance(tree, dict) and {"params", "opt_state", "step"} <= set(
        tree)


def load_any_checkpoint(path: str, keep_full_state: bool = False) -> Any:
    """Load a flax msgpack pytree or a torch .pth (converted). A
    full-state checkpoint is unwrapped to its params, unless
    keep_full_state (the whole tree, for an exact resume)."""
    if path.endswith((".pth", ".pt", ".bin")):
        from xlxmert_tpu_torch.core.convert import load_torch_checkpoint

        return load_torch_checkpoint(path)
    tree = load_pytree(path)
    if is_full_state_tree(tree) and not keep_full_state:
        return tree["params"]
    return tree


def same_layout(want: Any, got: Any, what: str, path: str = "") -> None:
    """Raise unless `got` has `want`'s nested-dict structure and leaf
    shapes (a checkpoint of another config fails loudly)."""
    where = path or "/"
    if isinstance(want, dict) != isinstance(got, dict):
        raise ValueError(f"{what}: {where} is not the model's kind of node "
                         "(a different config?)")
    if not isinstance(want, dict):
        if tuple(np.shape(want)) != tuple(np.shape(got)):
            raise ValueError(f"{what}: {where} has shape {np.shape(got)}, "
                             f"the model's {np.shape(want)} (a different "
                             "config?)")
        return
    if set(want) != set(got):
        raise ValueError(f"{what}: {where} holds {sorted(got)}, the model's "
                         f"state {sorted(want)} (a different config?)")
    for k in want:
        same_layout(want[k], got[k], what, f"{path}/{k}")


def _at(tree: Any, path: Tuple[str, ...]) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _param_paths(opt) -> Dict[str, Tuple[Tuple[str, ...], Any]]:
    """{parameter name: (its flax path, the transpose its value takes)}."""
    from xlxmert_tpu_torch.core.convert import flax_path

    return {n: flax_path(n, p.dim()) for n, p in opt.params.items()}


def _tree_of(paths: Dict[str, Tuple[Tuple[str, ...], Any]],
             values: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, (path, _) in paths.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = values[name]
    return tree


def train_state_to_tree(state, total_steps: Optional[int] = None) -> dict:
    """A TrainState (tasks/finetune.TrainState with its ReferenceAdamW) ->
    the JAX package's full-state tree {params, opt_state, step[,
    total_steps]}, numpy on the host: params in the flax layout;
    opt_state as flax writes BertAdamState (`count`: an int32 scalar per
    parameter, `mu` and `nu` in the params' layout, `sched_step` an
    int32 scalar); `total_steps`, the schedule's horizon, lets a resume
    see a changed one. The reference saves only the model and restarts
    Adam and the schedule on resume (lxmert_pretrain.py:675-685): this
    is the exact resume's state. A state on the card is copied to the
    host; on the CPU the leaves may share the state's memory, so the
    next step changes them (AsyncCheckpointer.save_full snapshots)."""
    from xlxmert_tpu_torch.core.convert import convert_torch_state_dict

    opt = state.opt
    paths = _param_paths(opt)
    tree = {"params": state.params(),
            "opt_state": {
                "count": _tree_of(paths, {
                    n: np.asarray(c, np.int32) for n, c in
                    opt.count.items()}),
                "mu": convert_torch_state_dict(opt.m),
                "nu": convert_torch_state_dict(opt.v),
                "sched_step": np.asarray(opt.sched_step, np.int32)},
            "step": np.asarray(state.step, np.int32)}
    if total_steps is not None:
        tree["total_steps"] = np.asarray(total_steps, np.int32)
    return tree


def _full_layout(state) -> dict:
    """train_state_to_tree's structure and shapes without a copy (leaves
    are zero-stride views)."""
    opt = state.opt
    paths = _param_paths(opt)
    shaped = {}
    for name, p in opt.params.items():
        perm = paths[name][1]
        shape = tuple(p.shape) if perm is None else tuple(
            p.shape[i] for i in perm)
        shaped[name] = np.broadcast_to(np.float32(0), shape)
    params = _tree_of(paths, shaped)
    scalar = np.broadcast_to(np.int32(0), ())
    return {"params": params,
            "opt_state": {"count": _tree_of(paths, dict.fromkeys(
                opt.params, scalar)), "mu": params, "nu": params,
                "sched_step": scalar},
            "step": scalar}


def restore_train_state(state, tree_or_path) -> Optional[int]:
    """Load a full-state tree (train_state_to_tree's layout, as the JAX
    package's cli/pretrain --save_full_state writes it; or the path of
    its msgpack) into `state` in place: parameters, Adam's moments,
    per-parameter counts, the schedule position and the step. The
    structure and shapes must be the model's (a loud failure when the
    config changed between save and resume). Returns the saved
    total_steps (None when the file has none): the caller compares it
    with its own horizon."""
    import torch

    from xlxmert_tpu_torch.core.convert import flax_to_state_dict

    tree = (load_pytree(tree_or_path) if isinstance(tree_or_path, str)
            else dict(tree_or_path))
    saved_total = tree.pop("total_steps", None)
    same_layout(_full_layout(state), tree, "full-state checkpoint")
    opt, opt_tree = state.opt, tree["opt_state"]
    state.load_params(tree["params"])
    with torch.no_grad():
        for moments, sub in ((opt.m, opt_tree["mu"]), (opt.v, opt_tree["nu"])):
            for name, value in flax_to_state_dict(sub).items():
                moments[name] = value.to(opt.params[name].device)
    for name, (path, _) in _param_paths(opt).items():
        opt.count[name] = int(np.asarray(_at(opt_tree["count"], path)))
    opt.sched_step = int(np.asarray(opt_tree["sched_step"]))
    state.step = int(np.asarray(tree["step"]))
    return None if saved_total is None else int(np.asarray(saved_total))


def epoch_ckpt_name(epoch: int) -> str:
    """The reference's name: Epoch%02d_LXRT (lxmert_pretrain.py:549)."""
    return f"Epoch{epoch:02d}_LXRT.msgpack"


def parse_start_epoch(path: str) -> int:
    """The epoch to resume at, from a checkpoint's name
    (lxmert_pretrain.py:679-685)."""
    m = re.search(r"Epoch(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


class AsyncCheckpointer:
    """Writes checkpoints on a background thread while training goes on.
    `save` takes its host snapshot on the caller's thread (the trainer
    updates its parameters in place, so a later copy would race the next
    step), then serializes and writes in the background. At most one
    save is in flight: `save` first waits for the previous one and
    re-raises any error it hit, as `wait` does; call `wait` in a
    `finally` before exit."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, tree: Any, path: str) -> None:
        self.wait()
        host = _copy_tree(tree)

        def work():
            try:
                save_pytree(host, path)
            except BaseException as e:  # re-raised on the caller's thread
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_full(self, full_tree: Any, full_path: str,
                  params_path: str) -> None:
        """One host snapshot, two files: the full train state
        (train_state_to_tree) at `full_path` and its params, the
        Epoch%02d_LXRT file, at `params_path`, both written on the
        writer thread. The tree is already on the host
        (train_state_to_tree copies from the card): no second device
        copy is made."""
        self.wait()
        host = _copy_tree(full_tree)

        def work():
            try:
                save_pytree(host, full_path)
                save_pytree(host["params"], params_path)
            except BaseException as e:  # re-raised on the caller's thread
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _copy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)
