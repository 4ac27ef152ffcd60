"""Per-corpus extractor manifests (the port's copy of
xlxmert_tpu/data/corpora.py): file listing, image-id, and output
h5 naming conventions of the reference's four grid/bbox extractor
variants, unified behind one table.

Reference conventions being reproduced (feature_extraction/):
  - COCO  (coco_extract_*_feature.py:18-22,212-232): images under
    <root>/images/{train2014,val2014,test2015} keyed by CLI split
    {train,valid,test}; flat listing; img_id = filename stem (keeps the
    COCO_*_%012d zero-padded form); output
    features/<backbone>_<split>_grid<g>[_imsize<s>].h5 and
    features/<backbone>_<split>_boxes36.h5.
  - VG    (VG_extract_*_feature.py:110-131,213-229): <root> IS the image
    dir (VG_100K + VG_100K_2 subdirs in the wild) — recursive *.jpg
    glob, unreadable files skipped; NO split in the name:
    features/<backbone>_grid<g>.h5 / _boxes36.h5.
  - GQA   (GQA_extract_*_feature.py:112-120,213-230): images under
    <root>/images, recursive *.jpg, unreadable skipped; no split in the
    name (GQA ids span splits in one file).
  - NLVR2 (nlvr2_extract_*_feature.py:18-22,212-231): images under
    <root>/images/{train,dev,test1} keyed by split {train,valid,test};
    recursive *.png (NLVR2 nests train/0..99 subdirs); img_id = stem
    (e.g. train-10108-0-img0).

The pretrain/finetune loaders (data/datasets.py) read the catalogs from
data/{mscoco,vg_gqa,nlvr2}_imgfeat/; `catalog_h5_name` maps each
corpus+split to the name those loaders expect, so
extract -> (sym)link into data/ -> train reproduces the reference
pipeline end to end.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CORPORA = ("coco", "vg", "gqa", "nlvr2")


@dataclass(frozen=True)
class CorpusLayout:
    # split -> images subdirectory (None: corpus has no split dirs)
    split_dirs: Optional[Dict[str, str]]
    images_subdir: str     # "" when <root> is itself the image dir (VG)
    recursive: bool        # rglob (GQA/NLVR2/VG) vs flat iterdir (COCO)
    exts: Tuple[str, ...]
    split_in_name: bool    # output h5 carries the split (COCO/NLVR2)
    verify_readable: bool  # VG/GQA skip unreadable files


LAYOUTS: Dict[str, CorpusLayout] = {
    "coco": CorpusLayout(
        split_dirs={"train": "train2014", "valid": "val2014",
                    "test": "test2015"},
        images_subdir="images", recursive=False,
        exts=(".jpg", ".jpeg"), split_in_name=True, verify_readable=False),
    "vg": CorpusLayout(
        split_dirs=None, images_subdir="", recursive=True,
        exts=(".jpg", ".jpeg"), split_in_name=False, verify_readable=True),
    "gqa": CorpusLayout(
        split_dirs=None, images_subdir="images", recursive=True,
        exts=(".jpg", ".jpeg"), split_in_name=False, verify_readable=True),
    "nlvr2": CorpusLayout(
        split_dirs={"train": "train", "valid": "dev", "test": "test1"},
        images_subdir="images", recursive=True,
        exts=(".png",), split_in_name=True, verify_readable=False),
}


def corpus_image_dir(corpus: str, root: Path, split: Optional[str]) -> Path:
    lay = LAYOUTS[corpus]
    d = Path(root)
    if lay.images_subdir:
        d = d / lay.images_subdir
    if lay.split_dirs is not None:
        if split not in lay.split_dirs:
            raise SystemExit(
                f"{corpus}: --split must be one of "
                f"{sorted(lay.split_dirs)} (got {split!r})")
        d = d / lay.split_dirs[split]
    return d


def corpus_image_paths(corpus: str, root: Path,
                       split: Optional[str]) -> List[Path]:
    """Sorted image paths per the corpus's listing convention. Sorting
    is OURS (the reference iterates filesystem order, which is not
    reproducible); ids are stems either way, so catalogs are
    content-identical."""
    lay = LAYOUTS[corpus]
    d = corpus_image_dir(corpus, root, split)
    if not d.is_dir():
        raise SystemExit(f"{corpus}: image dir {d} does not exist")
    if lay.recursive:
        paths = [p for ext in lay.exts for p in d.rglob(f"*{ext}")]
    else:
        paths = [p for p in d.iterdir() if p.suffix.lower() in lay.exts]
    paths = sorted(set(paths))
    if lay.verify_readable:
        from PIL import Image

        ok = []
        for p in paths:
            try:
                with Image.open(p):
                    pass
                ok.append(p)
            except OSError:
                continue
        paths = ok
    return paths


def extractor_h5_name(corpus: str, split: Optional[str], backbone: str,
                      kind: str = "grid", grid_size: int = 8,
                      imsize: Optional[int] = None,
                      n_boxes: int = 36) -> str:
    """The reference extractor's own output name (written under
    <root>/features/)."""
    lay = LAYOUTS[corpus]
    tag = f"_{split}" if lay.split_in_name else ""
    if kind == "grid":
        suffix = f"_imsize{imsize}" if imsize else ""
        return f"{backbone}{tag}_grid{grid_size}{suffix}.h5"
    if kind == "bbox":
        return f"{backbone}{tag}_boxes{n_boxes}.h5"
    raise ValueError(kind)


def extractor_output_path(corpus: str, root: Path, split: Optional[str],
                          backbone: str, kind: str = "grid",
                          grid_size: int = 8, imsize: Optional[int] = None,
                          n_boxes: int = 36) -> Path:
    return (Path(root) / "features"
            / extractor_h5_name(corpus, split, backbone, kind,
                                grid_size, imsize, n_boxes))


def catalog_h5_name(corpus: str, split: Optional[str], backbone: str,
                    kind: str = "grid", grid_size: int = 8,
                    n_boxes: int = 36) -> str:
    """Name + subdir the training loaders expect under data/
    (data/datasets.py:140-210): mscoco_imgfeat/<enc>_<split>_grid<g>.h5,
    vg_gqa_imgfeat/<enc>_vg_gqa_grid<g>.h5,
    nlvr2_imgfeat/<enc>_<split>_grid<g>.h5 (splits train/valid/test)."""
    g = (f"grid{grid_size}" if kind == "grid" else f"boxes{n_boxes}")
    if corpus == "coco":
        return f"mscoco_imgfeat/{backbone}_{split}_{g}.h5"
    if corpus in ("vg", "gqa"):
        return f"vg_gqa_imgfeat/{backbone}_vg_gqa_{g}.h5"
    if corpus == "nlvr2":
        return f"nlvr2_imgfeat/{backbone}_{split}_{g}.h5"
    raise ValueError(corpus)
