"""Per-task datasets producing fixed-shape numpy batches (port of
xlxmert_tpu/data/datasets.py: the fine-tuning datasets and the
pre-training `PretrainDataset`).

Mirrors the reference Dataset/collate/Evaluator triples (SURVEY.md §1 L2):
  - VQA:  data/vqa/{split}.json + trainval_ans2label/label2ans
    (vqa_data.py:20-222), soft-target vectors (:209-218)
  - GQA:  data/gqa/{split}.json + ans2label (gqa_data.py:20-207)
  - NLVR2: data/nlvr2/{split}.json, two images/example (nlvr2_data.py:56-196)
  - pre-training: caption corpora data/lxmert/{source}.json with cluster
    ids, bbox or grid features (lxmert_data.py:45-494)

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
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from xlxmert_tpu_torch.data.evaluators import (
    GQAEvaluator, NLVR2Evaluator, VQAEvaluator,
)
from xlxmert_tpu_torch.data.io import ClusterMap, GridFeatureReader, load_json
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


class PretrainDataset:
    """Caption corpora flattened to (img_id, sent) pairs with cluster-id
    visual input and matched-task negative sampling
    (lxmert_data.py:45-95,102-494).

    Data layout per source json: [{img_id, sentf: {source: [sents]},
    labelf: {source: [{ans: score}]}}, ...].
    """

    def __init__(self, corpus: List[dict], tokenizer: Tokenizer,
                 cluster_map: Optional[ClusterMap] = None,
                 feat_reader: Optional[GridFeatureReader] = None,
                 max_text_length: int = 20, grid_size: int = 8,
                 topk: int = -1,
                 answer_table=None,
                 vis_mask_sources: Optional[set] = None,
                 bbox_readers: Optional[Dict[str, Any]] = None):
        """answer_table: data/answer_table.AnswerTable enables QA labels
        (answer sampled per example, lxmert_data.py:366-388).
        vis_mask_sources: when set (e.g. {"mscoco"} for --vis_mask_COCO_only
        or {"mscoco", "vg"} for --vis_mask_COCOVG_only), batches carry a
        substitute example from those sources for the vis_mask task
        (lxmert_data.py:466-492).
        bbox_readers: the NON-clustering bbox path (reference
        lxmert_data.py:195-201,277-344): {img_source: BboxFeatureReader}
        routing each image to its boxes36 h5; batches then carry real
        features, detector obj ids, and per-image normalized boxes
        instead of cluster ids.

        Modes (reference lxmert_data.py:186-201 routes h5 files on
        grid_model, independent of clustering):
        - clustering: cluster_map set; feat_reader optionally adds exact
          grid features (feat-loss targets, data_out 'feat')
        - bbox: bbox_readers set (non-clustering, grid_model=False)
        - grid-feat: neither set, feat_reader required — exact grid
          features ARE the visual input (non-clustering, grid_model)

        feat_reader may be a single GridFeatureReader or an
        {img_source: reader} dict (per-source h5 routing like
        bbox_readers)."""
        if cluster_map is not None and bbox_readers is not None:
            raise ValueError(
                "cluster_map (clustering mode) and bbox_readers "
                "(bbox-feature mode) are mutually exclusive")
        if (cluster_map is None and bbox_readers is None
                and feat_reader is None):
            raise ValueError(
                "grid-feat mode (no cluster_map, no bbox_readers) needs "
                "a feat_reader for the exact grid features")
        self.tokenizer = tokenizer
        self.clusters = cluster_map
        self.bbox_readers = bbox_readers
        self.feat = feat_reader
        self.max_text_length = max_text_length
        self.grid_size = grid_size
        self.answer_table = answer_table
        self.vis_mask_sources = vis_mask_sources
        # flatten captions (lxmert_data.py:45-95)
        self.examples: List[dict] = []
        for datum in corpus:
            img_id = datum["img_id"]
            if cluster_map is not None:
                if img_id not in cluster_map:
                    continue
            elif bbox_readers is not None:
                reader = bbox_readers.get(datum.get("img_source", ""))
                if reader is None or img_id not in reader:
                    continue
            else:  # grid-feat mode: membership in the routed grid h5
                reader = (feat_reader.get(datum.get("img_source", ""))
                          if isinstance(feat_reader, dict) else feat_reader)
                if reader is None or img_id not in reader:
                    continue
            img_source = datum.get("img_source", "")
            for source, sents in datum.get("sentf", {}).items():
                labels = datum.get("labelf", {}).get(source)
                for i, sent in enumerate(sents):
                    ex = {"uid": f"{img_id}_{source}_{i}", "img_id": img_id,
                          "sent": sent, "source": source,
                          "img_source": img_source or source}
                    if labels is not None and i < len(labels) and labels[i]:
                        ex["label"] = labels[i]
                    self.examples.append(ex)
        if topk and topk > 0:
            self.examples = self.examples[:topk]
        self._vis_pool: List[int] = []
        if vis_mask_sources:
            # image source decides eligibility (lxmert_data.py:477
            # `'mscoco' in coco_datum['img_source']`)
            self._vis_pool = [
                i for i, ex in enumerate(self.examples)
                if any(s in ex["img_source"] for s in vis_mask_sources)]

    def _qa_label(self, ex, rng) -> int:
        """Sample one answer id from the soft-label dict
        (lxmert_data.py:366-388); -1 = no QA supervision."""
        label = ex.get("label")
        if not label or self.answer_table is None:
            return -1
        ids, scores = [], []
        for ans, score in label.items():
            ans = self.answer_table.convert_ans(ans)
            if self.answer_table.used(ans):
                ids.append(self.answer_table.ans2id(ans))
                scores.append(score)
        if not ids:
            return -1
        if len(ids) == 1:
            return ids[0]
        total = sum(scores)
        r = rng.random() * total
        acc = 0.0
        for i, s in zip(ids, scores):
            acc += s
            if r <= acc:
                return i
        return ids[-1]

    def __len__(self):
        return len(self.examples)

    def shard(self, process_index: int, process_count: int):
        self.examples = self.examples[process_index::process_count]
        return self

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                with_feats: bool = False, drop_last: bool = False):
        rng = random.Random(seed)
        order = list(range(len(self.examples)))
        if shuffle:
            rng.shuffle(order)
        n = len(self.examples)
        V = self.grid_size ** 2
        end = len(order)
        if drop_last and end >= batch_size:
            # training: a padded partial batch would give its last real
            # example up-to-B-fold gradient weight (the reference's torch
            # loader emits a smaller batch; batches here keep one shape,
            # so the tail is dropped instead; < 1 batch/epoch)
            end -= end % batch_size
        elif drop_last and 0 < end < batch_size:
            # dataset smaller than one batch: dropping would emit zero
            # batches, so a padded batch goes out anyway — with the
            # duplicated-example gradient bias drop_last exists to avoid
            import logging

            logging.getLogger("xlxmert").warning(
                "drop_last=True but the (sharded) dataset has only %d "
                "examples < batch_size=%d: emitting one padded batch "
                "(last example duplicated with full gradient weight)",
                end, batch_size)
        for s in range(0, end, batch_size):
            data = [self.examples[i] for i in order[s:s + batch_size]]
            word_ids = self.tokenizer.encode_batch(
                [d["sent"] for d in data], self.max_text_length)
            # matched-task negatives: prob 0.5 swap in a random other
            # sentence, label 0 (lxmert_data.py:346-364)
            other_sents, matched = [], []
            for d in data:
                o = None
                if rng.random() < 0.5 and n > 1:
                    # bounded: a sharded/truncated corpus can be all
                    # captions of ONE image — the reference's unbounded
                    # retry (lxmert_data.py:350-357) would spin forever
                    for _ in range(20):
                        cand = self.examples[rng.randrange(n)]
                        if cand["img_id"] != d["img_id"]:
                            o = cand
                            break
                if o is not None:
                    other_sents.append(o["sent"])
                    matched.append(0)
                else:
                    other_sents.append(d["sent"])
                    matched.append(1)
            other_ids = self.tokenizer.encode_batch(
                other_sents, self.max_text_length)
            batch = {
                "uids": [d["uid"] for d in data],
                "n_valid": len(data),
                "word_id": _pad_batch(list(word_ids), batch_size),
                "other_word_id": _pad_batch(list(other_ids), batch_size),
                "matched_label": _pad_batch(
                    [np.int32(m) for m in matched], batch_size),
            }
            if self.clusters is not None:
                batch["cluster_id"] = _pad_batch(
                    [self.clusters.get(d["img_id"]) for d in data],
                    batch_size)
            elif self.bbox_readers is not None:
                # bbox path (lxmert_data.py:277-344): real detector
                # features, obj ids, and per-image [0,1] boxes
                rows = [self.bbox_readers[d["img_source"]].get(d["img_id"])
                        for d in data]
                batch["vis_feats"] = _pad_batch(
                    [r["features"] for r in rows], batch_size)
                batch["obj_id"] = _pad_batch(
                    [r["obj_id"] for r in rows], batch_size)
                batch["boxes"] = _pad_batch(
                    [r["boxes"] for r in rows], batch_size)
            if self.answer_table is not None:
                batch["qa_label"] = _pad_batch(
                    [np.int32(self._qa_label(d, rng)) for d in data],
                    batch_size)
            if self._vis_pool:
                # substitute COCO/VG example for the vis_mask task. The
                # reference substitutes the CAPTION on every path but the
                # visual input only in clustering mode — on the bbox/grid
                # paths the original image features stay
                # (lxmert_pretrain.py:594-598, lxmert_data.py:481-492)
                subs = [self.examples[self._vis_pool[
                    rng.randrange(len(self._vis_pool))]] for _ in data]
                sub_ids = self.tokenizer.encode_batch(
                    [s["sent"] for s in subs], self.max_text_length)
                batch["coco_word_id"] = _pad_batch(list(sub_ids), batch_size)
                if self.clusters is not None:
                    batch["coco_cluster_id"] = _pad_batch(
                        [self.clusters.get(s["img_id"]) for s in subs],
                        batch_size)
            if self.feat is not None and (
                    with_feats or self.bbox_readers is None):
                # exact grid features: the visual input in grid-feat
                # mode, feat-loss targets under clustering
                # (data_out 'feat', lxmert_pretrain.py:733)
                batch["vis_feats"] = _pad_batch(
                    [self._grid_feat(d, V) for d in data], batch_size)
            yield batch

    def _grid_feat(self, d, V):
        r = (self.feat[d["img_source"]] if isinstance(self.feat, dict)
             else self.feat)
        return r.get(d["img_id"]).reshape(V, -1)
