"""Torch state_dict -> flax-layout nested parameter dict (the port's copy
of xlxmert_tpu/core/convert.py::convert_torch_state_dict).

The serving engine reads parameters in the reference's flax layout, so a
released torch checkpoint is converted to that layout first:
  - `module.` DDP prefixes are stripped;
  - list-module indices fold into the parent name (`encoder.layer.3.` ->
    `layer_3`);
  - Linear `weight` (out, in) -> `kernel` (in, out); Conv2d `weight`
    (out, in, kh, kw) -> `kernel` (kh, kw, in, out); 1-D `weight` ->
    `scale`; embedding tables stay row-major as `embedding`;
  - weight-tied tensors are dropped; `out_cluster.bias` becomes the flat
    param `out_cluster_bias`.

`load_bert_state_dict` overlays bert-base-uncased weights for
pre-training's default initialization, and `extract_centroids` pulls the
frozen centroid table out of a reference checkpoint.

`flax_to_state_dict` goes the other way for the port's own modules
(models/), so a flax tree loads into them and
`convert_torch_state_dict(model.state_dict())` gives the tree back.
`split_variables` sorts a converted generator checkpoint into flax's
variable collections (params, batch-norm statistics, spectral-norm u/v).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

_EMBEDDING_PARENTS = frozenset({
    "word_embeddings", "position_embeddings", "token_type_embeddings",
    "vis_emb", "emb", "embedding",
})

_TIED_KEYS = frozenset({
    "cls.predictions.decoder.weight",
    "obj_predict_head.out_cluster.weight",
    "emb_classifier.weight",
})


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the `module.` DDP prefix; keys without it are kept."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def _fold_indices(key: str) -> Tuple[str, ...]:
    """`encoder.layer.3.attention.self.query` -> (encoder, layer_3, ...)."""
    out: list = []
    for p in key.split("."):
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return tuple(out)


def _insert(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def flax_path(key: str, ndim: int
              ) -> Tuple[Optional[Tuple[str, ...]], Optional[Tuple[int, ...]]]:
    """(path, perm) of a torch state-dict entry `key` (no DDP prefix)
    holding `ndim` dimensions: its path in the flax tree and the
    transpose its value takes there (None: as it is). The path is None
    for entries the tree leaves out (weight-tied tensors, BN step
    counters)."""
    if key in _TIED_KEYS or key.endswith("num_batches_tracked"):
        return None, None
    path = list(_fold_indices(key))
    leaf = path[-1]
    if leaf == "running_mean":
        path[-1] = "mean"
    elif leaf == "running_var":
        path[-1] = "var"
    perm = None
    if key == "obj_predict_head.out_cluster.bias":
        path = ["obj_predict_head", "out_cluster_bias"]
    elif key == "emb_classifier.bias":
        path = ["emb_classifier_bias"]
    elif leaf in ("weight", "weight_orig"):
        parent = path[-2] if len(path) >= 2 else ""
        if ndim == 1:
            path[-1] = "scale"
        elif ndim == 2 and parent in _EMBEDDING_PARENTS:
            path[-1] = "embedding"
        elif ndim == 2:
            path[-1], perm = "kernel", (1, 0)
        elif ndim == 4:
            path[-1], perm = "kernel", (2, 3, 1, 0)
        else:
            path[-1] = "kernel"
    return tuple(path), perm


def convert_torch_state_dict(state_dict: Mapping[str, Any]
                             ) -> Dict[str, Any]:
    """Generic torch state_dict -> flax-style nested param dict."""
    tree: Dict[str, Any] = {}
    for key, tensor in strip_ddp_prefix(state_dict).items():
        arr = _to_numpy(tensor)
        path, perm = flax_path(key, arr.ndim)
        if path is None:
            continue
        _insert(tree, path, arr if perm is None else arr.transpose(perm))
    return tree


def _unfold_index(name: str) -> str:
    """`layer_3` -> `layer.3`: the inverse of `_fold_indices`."""
    head, sep, tail = name.rpartition("_")
    return f"{head}.{tail}" if sep and head and tail.isdigit() else name


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = ""
                       ) -> Dict[str, Any]:
    """Flax-layout nested param dict (numpy leaves) -> torch state_dict
    for the port's modules, which keep HF LXMERT's attribute names: the
    inverse of `convert_torch_state_dict` for Linear, LayerNorm and
    embedding leaves (`kernel` (in, out) -> `weight` (out, in); a conv
    `kernel` (kh, kw, in, out) -> `weight` (out, in, kh, kw); `scale`
    and `embedding` -> `weight`; `layer_3` -> `layer.3`). Values are
    fp32 CPU tensors."""
    import torch

    out: Dict[str, Any] = {}
    for name, node in tree.items():
        if isinstance(node, Mapping):
            out.update(flax_to_state_dict(
                node, f"{prefix}{_unfold_index(name)}."))
            continue
        arr = np.asarray(node)
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:  # (kh, kw, in, out) -> (out, in, kh, kw)
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{prefix}kernel: only 2-D (Linear) and "
                                 f"4-D (Conv2d) kernels map to weights, got "
                                 f"shape {arr.shape}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[prefix + name] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a .pth file on the host and convert it."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd and all(
            not hasattr(v, "shape") for k, v in sd.items()
            if k != "state_dict"):
        sd = sd["state_dict"]
    return convert_torch_state_dict(sd)


def split_variables(tree: Mapping[str, Any]) -> Dict[str, Dict]:
    """Split a converted tree into flax variable collections:
    {'params': ..., 'batch_stats': ... (BN mean/var), 'sn': ...
    (spectral-norm u/v)}. Empty collections are omitted."""
    def walk(node, out):
        for k, v in node.items():
            if isinstance(v, Mapping):
                sub: Dict[str, Dict] = {}
                walk(v, sub)
                for col, subtree in sub.items():
                    out.setdefault(col, {})[k] = subtree
            elif k in ("mean", "var"):
                out.setdefault("batch_stats", {})[k] = v
            elif k in ("weight_u", "weight_v"):
                out.setdefault("sn", {})["u" if k == "weight_u" else "v"] = v
            else:
                out.setdefault("params", {})[k] = v

    out: Dict[str, Dict] = {}
    walk(tree, out)
    return out


def load_bert_state_dict(state_dict_or_path, l_layers: int = 9) -> Dict[str, Any]:
    """bert-base-uncased torch state_dict -> XLxmert param overlay.

    The reference initializes pretraining with
    `XLxmertForPretraining.from_pretrained('bert-base-uncased')`
    (lxmert_pretrain.py:58-61), which maps BERT weights by name overlap:
    the model's language attribute is literally named `bert` (lxrt/
    modeling.py:80) and HF names the LXMERT language stack `layer`, so
    `bert.embeddings.*`, `bert.encoder.layer.{0..l_layers-1}.*`,
    `bert.pooler.*`, `cls.predictions.*` (LM head) and
    `cls.seq_relationship.*` (NSP -> matched head) all land; BERT layers
    >= l_layers and everything else are dropped. `--fromScratch`
    (param.py:90-93) is the documented opt-out.

    Accepts a `.pth`/`.bin` path or an in-memory state_dict; handles both
    BertForPreTraining (`bert.`-prefixed) and bare BertModel key layouts.
    Returns a nested tree to overlay via `core.checkpoint.merge_params`
    (the visual stacks, cross stacks, and heads stay at their random
    init, exactly like the reference's strict=False name-overlap load).
    """
    if isinstance(state_dict_or_path, (str,)) or hasattr(state_dict_or_path,
                                                         "__fspath__"):
        import torch  # host-side only

        sd = torch.load(str(state_dict_or_path), map_location="cpu",
                        weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd and not hasattr(
                sd.get("state_dict"), "shape"):
            sd = sd["state_dict"]
    else:
        sd = state_dict_or_path
    sd = strip_ddp_prefix(sd)
    # the canonical 2019-era bert-base-uncased pytorch_model.bin names
    # LayerNorm params `gamma`/`beta`; modern transformers re-exports use
    # `weight`/`bias` (transformers' own from_pretrained does this same
    # rename). Normalize so either vintage converts.
    sd = {(k[:-6] + ".weight" if k.endswith(".gamma")
           else k[:-5] + ".bias" if k.endswith(".beta") else k): v
          for k, v in sd.items()}
    if not any(k.startswith("bert.") for k in sd):
        # bare BertModel layout -> BertForPreTraining layout
        sd = {("bert." + k if not k.startswith("cls.") else k): v
              for k, v in sd.items()}

    kept: Dict[str, Any] = {}
    for key, tensor in sd.items():
        if key.endswith("position_ids"):  # HF buffer, not a weight
            continue
        if key == "cls.predictions.decoder.bias":  # tied to cls.predictions.bias
            continue
        if key.startswith("bert.encoder.layer."):
            idx = int(key.split(".")[3])
            if idx >= l_layers:
                continue  # BERT has 12 layers; the language stack takes 9
        elif not (key.startswith("bert.embeddings.")
                  or key.startswith("bert.pooler.")
                  or key.startswith("cls.predictions.")
                  or key.startswith("cls.seq_relationship.")):
            continue  # NSP pooler variants, heads we don't have, etc.
        kept[key] = tensor
    return convert_torch_state_dict(kept)


def extract_centroids(state_dict: Mapping[str, Any]) -> Optional[np.ndarray]:
    """Pull the frozen centroid table (`vis_emb.weight`) out of a reference
    checkpoint, if present."""
    sd = strip_ddp_prefix(state_dict)
    for k in ("vis_emb.weight", "module.vis_emb.weight"):
        if k in sd:
            return _to_numpy(sd[k])
    return None
