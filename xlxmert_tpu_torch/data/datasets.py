"""Per-task datasets producing fixed-shape numpy batches (port of the
fine-tuning part of xlxmert_tpu/data/datasets.py; `PretrainDataset`
comes with pre-training).

Mirrors the reference Dataset/collate/Evaluator triples (SURVEY.md §1 L2):
  - VQA:  data/vqa/{split}.json + trainval_ans2label/label2ans
    (vqa_data.py:20-222), soft-target vectors (:209-218)
  - GQA:  data/gqa/{split}.json + ans2label (gqa_data.py:20-207)
  - NLVR2: data/nlvr2/{split}.json, two images/example (nlvr2_data.py:56-196)

Static-shape discipline (SURVEY.md §7): text pads to max_text_length, the
final partial batch pads to full batch size and reports `n_valid`; these
classes only assemble ids, features, and labels. The constructors take
any feature reader with `.get(img_id)` (an HDF5 `GridFeatureReader`, or
an in-memory table); only `from_files` opens HDF5. The JAX package's per-process `shard`
comes with distributed training.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, Iterable, List

import numpy as np

from xlxmert_tpu_torch.data.evaluators import (
    GQAEvaluator, NLVR2Evaluator, VQAEvaluator,
)
from xlxmert_tpu_torch.data.io import GridFeatureReader, load_json
from xlxmert_tpu_torch.data.tokenization import Tokenizer
from xlxmert_tpu_torch.utils.boxes import box_position


def _pad_batch(arrs: List[np.ndarray], batch_size: int) -> np.ndarray:
    """Stack and pad the final partial batch by repeating the last row."""
    out = np.stack(arrs)
    if len(arrs) < batch_size:
        reps = np.repeat(out[-1:], batch_size - len(arrs), axis=0)
        out = np.concatenate([out, reps])
    return out


class _QABase:
    """Shared machinery for VQA/GQA-style datasets."""

    def __init__(self, data: List[dict], tokenizer: Tokenizer,
                 feat_reader: GridFeatureReader, ans2label: Dict[str, int],
                 label2ans: List[str], max_text_length: int = 20,
                 grid_size: int = 8, topk: int = -1):
        if topk and topk > 0:
            data = data[:topk]
        self.data = data
        self.tokenizer = tokenizer
        self.feat = feat_reader
        self.ans2label = ans2label
        self.label2ans = label2ans
        self.max_text_length = max_text_length
        self.grid_size = grid_size
        self.boxes = box_position(grid_size)
        self.id2datum = {d["question_id"]: d for d in data}
        self.num_answers = len(ans2label)

    def __len__(self):
        return len(self.data)

    def _target(self, datum) -> np.ndarray:
        """Soft-score target vector (vqa_data.py:209-218)."""
        t = np.zeros((self.num_answers,), np.float32)
        for ans, score in datum.get("label", {}).items():
            if ans in self.ans2label:
                t[self.ans2label[ans]] = score
        return t

    def _reader_for(self, datum):
        """Per-datum h5 routing: the reference tags every datum with its
        source split and maps source -> h5 (vqa_data.py:83-121) — e.g.
        --train train,nominival mixes train2014 and val2014 images."""
        if isinstance(self.feat, dict):
            return self.feat[datum["_h5"]]
        return self.feat

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, test: bool = False,
                drop_last: bool = False) -> Iterable[Dict[str, Any]]:
        order = list(range(len(self.data)))
        if shuffle:
            random.Random(seed).shuffle(order)
        V = self.grid_size ** 2
        end = len(order)
        if drop_last and end >= batch_size:
            end -= end % batch_size
        for s in range(0, end, batch_size):
            idxs = order[s:s + batch_size]
            data = [self.data[i] for i in idxs]
            word_ids = self.tokenizer.encode_batch(
                [d["sent"] for d in data], self.max_text_length)
            feats = [self._reader_for(d).get(d["img_id"]).reshape(V, -1)
                     for d in data]
            batch = {
                "question_ids": [d["question_id"] for d in data],
                "n_valid": len(data),
                "word_ids": _pad_batch(list(word_ids), batch_size),
                "vis_feats": _pad_batch(feats, batch_size),
                "boxes": np.broadcast_to(
                    self.boxes[None], (batch_size, V, 4)).copy(),
            }
            if not test:
                batch["targets"] = _pad_batch(
                    [self._target(d) for d in data], batch_size)
            yield batch


class VQADataset(_QABase):
    """data/vqa/{split}.json (+ trainval_ans2label/label2ans)."""

    @classmethod
    def from_files(cls, data_root, splits: str, tokenizer,
                   encoder: str = "maskrcnn", grid_size: int = 8, **kw):
        root = Path(data_root)

        # h5 routing PER SOURCE SPLIT (vqa_data.py:83-121): each datum is
        # tagged with its split's h5 family — --train train,nominival
        # mixes train2014 and val2014 images in one run
        def fam(split):
            if "train" in split:
                return "train"
            if "nominival" in split or "minival" in split:
                return "valid"
            return "test"

        data: List[dict] = []
        readers: Dict[str, GridFeatureReader] = {}
        for split in splits.split(","):
            f = fam(split)
            if f not in readers:
                readers[f] = GridFeatureReader(
                    root / "mscoco_imgfeat"
                    / f"{encoder}_{f}_grid{grid_size}.h5")
            part = load_json(root / "vqa" / f"{split}.json")
            for d in part:
                d["_h5"] = f
            data.extend(part)
        ans2label = load_json(root / "vqa" / "trainval_ans2label.json")
        label2ans = load_json(root / "vqa" / "trainval_label2ans.json")
        feat = readers if len(readers) > 1 else next(iter(readers.values()))
        ds = cls(data, tokenizer, feat, ans2label, label2ans,
                 grid_size=grid_size, **kw)
        ds.evaluator = VQAEvaluator(ds.id2datum)
        return ds


class GQADataset(_QABase):
    """data/gqa/{split}.json; single vg_gqa h5 (gqa_data.py:66-207)."""

    @classmethod
    def from_files(cls, data_root, splits: str, tokenizer,
                   encoder: str = "maskrcnn", grid_size: int = 8, **kw):
        root = Path(data_root)
        data: List[dict] = []
        for split in splits.split(","):
            data.extend(load_json(root / "gqa" / f"{split}.json"))
        ans2label = load_json(root / "gqa" / "trainval_ans2label.json")
        label2ans = load_json(root / "gqa" / "trainval_label2ans.json")
        feat = GridFeatureReader(
            root / "vg_gqa_imgfeat" / f"{encoder}_vg_gqa_grid{grid_size}.h5")
        ds = cls(data, tokenizer, feat, ans2label, label2ans,
                 grid_size=grid_size, **kw)
        ds.evaluator = GQAEvaluator(ds.id2datum)
        return ds


class NLVR2Dataset:
    """data/nlvr2/{split}.json: {uid, img0, img1, sent, label, identifier}
    (nlvr2_data.py:20-196). Batches carry (B, 2, V, D) features."""

    def __init__(self, data: List[dict], tokenizer: Tokenizer,
                 feat_reader: GridFeatureReader, max_text_length: int = 20,
                 grid_size: int = 8, topk: int = -1):
        if topk and topk > 0:
            data = data[:topk]
        self.data = data
        self.tokenizer = tokenizer
        self.feat = feat_reader
        self.max_text_length = max_text_length
        self.grid_size = grid_size
        self.boxes = box_position(grid_size)
        self.id2datum = {d["uid"]: d for d in data}
        self.evaluator = NLVR2Evaluator(self.id2datum)

    @classmethod
    def from_files(cls, data_root, splits: str, tokenizer,
                   encoder: str = "maskrcnn", grid_size: int = 8, **kw):
        root = Path(data_root)
        # one h5 per split, routed per datum (the reference indexes
        # data_source_to_h5_path by the single split name,
        # nlvr2_data.py:75-90, and would KeyError on a comma list)
        data: List[dict] = []
        readers: Dict[str, GridFeatureReader] = {}
        for split in splits.split(","):
            if split not in readers:
                readers[split] = GridFeatureReader(
                    root / "nlvr2_imgfeat"
                    / f"{encoder}_{split}_grid{grid_size}.h5")
            part = load_json(root / "nlvr2" / f"{split}.json")
            for d in part:
                d["_h5"] = split
            data.extend(part)
        feat = readers if len(readers) > 1 else next(iter(readers.values()))
        return cls(data, tokenizer, feat, grid_size=grid_size, **kw)

    def __len__(self):
        return len(self.data)

    def _reader(self, datum):
        if isinstance(self.feat, dict):
            return self.feat[datum["_h5"]]
        return self.feat

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                test: bool = False, drop_last: bool = False):
        order = list(range(len(self.data)))
        if shuffle:
            random.Random(seed).shuffle(order)
        V = self.grid_size ** 2
        end = len(order)
        if drop_last and end >= batch_size:
            end -= end % batch_size
        for s in range(0, end, batch_size):
            data = [self.data[i] for i in order[s:s + batch_size]]
            word_ids = self.tokenizer.encode_batch(
                [d["sent"] for d in data], self.max_text_length)
            feats = [np.stack([self._reader(d).get(d["img0"]).reshape(V, -1),
                               self._reader(d).get(d["img1"]).reshape(V, -1)])
                     for d in data]
            batch = {
                "question_ids": [d["uid"] for d in data],
                "n_valid": len(data),
                "word_ids": _pad_batch(list(word_ids), batch_size),
                "vis_feats": _pad_batch(feats, batch_size),
                "boxes": np.broadcast_to(
                    self.boxes[None, None], (batch_size, 2, V, 4)).copy(),
            }
            if not test:
                batch["labels"] = _pad_batch(
                    [np.int32(d["label"]) for d in data], batch_size)
            yield batch
