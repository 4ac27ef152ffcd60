"""Batch VQA serving CLI on the GPU (port of xlxmert_tpu/cli/serve.py).

  - the image-feature catalog is loaded once into device memory as bf16
    (serving/feature_cache.py): a query ships only token ids and an
    image index;
  - the forward runs through the static-calibrated int8 engine
    (serving/lxmert_int8.py), whose denses and attention are the port's
    CUDA kernels, through the same engine with each encoder module's
    dense chain in the whole-block fused kernel (`serve(fused=True)`,
    serving/lxmert_fused.py; no flag, as in the reference), or with
    --bf16 through the bf16 VQAModel
    (models/task_heads.py) in serving mode, with every float parameter
    cast to bf16 and the packed-head attention kernel on the card;
  - answers stream to a jsonl, with throughput printed at the end.

Usage:
  python -m xlxmert_tpu_torch.cli.serve \\
      --load snap/vqa/BEST.msgpack --model_config model.yaml \\
      --h5 data/mscoco_imgfeat/maskrcnn_valid_grid8.h5 \\
      --vocab vocab.txt --label2ans trainval_label2ans.json \\
      --questions questions.jsonl --output answers.jsonl [--batch 256] \\
      [--buckets 8,12,16,20] [--device cuda] [--profile DIR]

questions.jsonl lines: {"question_id": ..., "img_id": ..., "sent": ...}.
--profile DIR traces the serving batches after the warm-up one (the
only batch, if there is one) with torch.profiler into DIR, a Chrome
trace for TensorBoard/Perfetto (utils/profiling.trace) in which each
int8 forward's stages are ranges beside the card's kernels:
"xlt.serve.inputs" (the copies to the card and the catalog gather),
"xlt.engine.language", "xlt.engine.visual", "xlt.engine.cross" and
"xlt.serve.head" (the answer head and the argmax). A traced stream runs
slower than an untraced one: keep it short.
`serve()` is the serving loop itself, callable with in-memory inputs;
`serving_forward()` (int8), `fused_serving_forward()` (int8, fused
blocks) and `bf16_serving_forward()` are the forwards it runs on every
batch.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--load", required=True, help="finetuned checkpoint "
                   "(.msgpack or .pth; params must hold bert+answer_head)")
    p.add_argument("--model_config", default=None, help="LxmertConfig yaml")
    p.add_argument("--h5", required=True, help="grid-feature h5")
    p.add_argument("--vocab", required=True)
    p.add_argument("--label2ans", required=True,
                   help="label -> answer json list")
    p.add_argument("--questions", required=True, help="jsonl of "
                   "{question_id, img_id, sent}")
    p.add_argument("--output", required=True, help="answers jsonl")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--max_text_length", type=int, default=20)
    p.add_argument("--buckets", default="",
                   help="comma-separated text lengths (e.g. 8,12,16,20): "
                   "route each question to the smallest bucket that fits "
                   "its token count instead of padding everything to "
                   "--max_text_length")
    p.add_argument("--bf16", action="store_true",
                   help="serve the bf16 model instead of the int8 engine")
    p.add_argument("--window", type=int, default=32,
                   help="batches dispatched ahead of the result fetch")
    p.add_argument("--calib_samples", type=int, default=256,
                   help="int8 activation-scale calibration reads this many "
                   "queries sampled across the whole --questions stream "
                   "(capped by the stream length)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                   "the kernels)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the serving batches after the warm-up one "
                   "with torch.profiler into DIR, a Chrome trace for "
                   "TensorBoard/Perfetto whose ranges are the engine's "
                   "stages")
    return p.parse_args(argv)


def serving_forward(qp, hqp, cache, cfg, device):
    """The forward `serve` runs on every batch: host tensors of token ids
    (B, L), catalog rows (B,) and the attention mask (B, L) in, each
    query's answer index out, left on `device` (not synchronized)."""
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine

    return _int8_forward(engine.lxmert_forward, qp, hqp, cache, cfg, device)


def fused_serving_forward(fp, hqp, cache, cfg, device):
    """The forward `serve(fused=True)` runs on every batch, as
    `serving_forward`: `fp` is serving/lxmert_fused.prepare_fused's tree
    of the calibrated engine."""
    from xlxmert_tpu_torch.serving.lxmert_fused import lxmert_forward_fused

    return _int8_forward(lxmert_forward_fused, fp, hqp, cache, cfg, device)


def _int8_forward(forward, tree, hqp, cache, cfg, device):
    import numpy as np
    import torch

    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.utils.boxes import box_position
    from xlxmert_tpu_torch.utils.profiling import span

    V = cache.table.shape[1]
    pos = torch.from_numpy(box_position(int(np.sqrt(V)))).to(
        device, torch.bfloat16)

    @torch.inference_mode()
    def run(ids, picks, mask):
        with span("xlt.serve.inputs"):
            ids, picks, mask = (t.to(device, non_blocking=True)
                                for t in (ids, picks, mask))
            feats = FeatureCache.lookup(cache.table, picks)
        _, _, pooled = forward(
            tree, ids, feats, pos[None].expand(ids.shape[0], V, 4),
            attention_mask=mask, n_heads=cfg.num_attention_heads)
        with span("xlt.serve.head"):
            return engine.answer_head_forward(hqp, pooled).argmax(-1)

    return run


def bf16_serving_forward(model, cache, device):
    """The forward `serve(bf16=True)` runs on every batch: host tensors of
    token ids (B, L), catalog rows (B,) and the attention mask (B, L) in,
    each query's answer index (logits.argmax(-1)) out, left on `device`
    (not synchronized). `model` is a bf16 VQAModel on `device`."""
    import numpy as np
    import torch

    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.utils.boxes import box_position

    V = cache.table.shape[1]
    pos = torch.from_numpy(box_position(int(np.sqrt(V)))).to(
        device, torch.bfloat16)

    @torch.inference_mode()
    def run(ids, picks, mask):
        ids, picks, mask = (t.to(device, non_blocking=True)
                            for t in (ids, picks, mask))
        feats = FeatureCache.lookup(cache.table, picks)
        logits = model(ids, feats, pos[None].expand(ids.shape[0], V, 4),
                       attention_mask=mask)
        return logits.argmax(-1)

    return run


def serve(questions: List[Dict], tokenizer, cache, params: Dict, cfg,
          label2ans: Sequence[str], output: str, *, batch: int = 256,
          max_text_length: int = 20, buckets: str = "", window: int = 32,
          calib_samples: int = 256, device="cuda", bf16: bool = False,
          attention: str = "auto", fused_ffn: bool = False,
          fused: bool = False,
          on_calibrated: Optional[Callable[[], None]] = None,
          profile: Optional[str] = None) -> Dict:
    """Calibrate the int8 engine on queries sampled across `questions`,
    then answer every question into `output` (jsonl); with fused=True
    through the whole-block fused engine built from the calibrated one
    (serving/lxmert_fused.py). `on_calibrated`, if given, is called once
    the engine is calibrated, before the first serving forward
    (chip_smoke.py reads the kernels' launch counts there). With
    bf16=True, serve the bf16 VQAModel instead, uncalibrated, in serving
    mode with `attention` ("auto": the packed-head kernel on the card;
    "einsum", "blhd" or "pallas") and `fused_ffn`
    (models/lxmert.ServingOptions). `profile`, a directory, traces the
    batches after the warm-up one into it (utils/profiling.trace; the
    warm-up too where it is the only batch).

    cache: a FeatureCache on `device` holding every referenced image;
    params: the flax-layout tree with "bert" and "answer_head" (numpy).
    Returns counts and rates: answers, forwards (calibration + serving),
    steady_qps, total_qps, and the engine: the calibrated (qp, head_qp),
    with fused=True (the fused tree, head_qp), or the bf16 VQAModel."""
    import numpy as np
    import torch

    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.utils.boxes import box_position
    from xlxmert_tpu_torch.utils.device import resolve_device
    from xlxmert_tpu_torch.utils.profiling import trace

    dev = resolve_device(device)
    if fused and bf16:
        raise ValueError("serve: fused=True runs the int8 engine; it "
                         "cannot be combined with bf16=True")
    if not questions:
        open(output, "w").close()
        print("served 0 answers")
        return {"answers": 0, "forwards": 0, "steady_qps": None,
                "total_qps": None, "engine": None}
    if calib_samples < 1 and not bf16:
        raise SystemExit("--calib_samples must be >= 1 (static int8 "
                         "scales need at least one calibration query)")
    B, L, V = batch, max_text_length, cache.table.shape[1]
    grid = int(np.sqrt(V))
    pos = torch.from_numpy(box_position(grid)).to(dev, torch.bfloat16)
    pin = dev.type == "cuda"

    def build_batch(chunk, size, length=L, ids_rows=None):
        """Tokenize/pad/index one batch: the one place serving inputs
        are assembled, shared by serving and calibration."""
        n_valid = len(chunk)
        chunk = chunk + [chunk[-1]] * (size - n_valid)
        if ids_rows is None:
            ids = tokenizer.encode_batch([q["sent"] for q in chunk], L)
        elif size > n_valid:
            ids = np.concatenate([ids_rows] + [ids_rows[-1:]]
                                 * (size - n_valid), 0)
        else:
            ids = ids_rows
        ids = np.ascontiguousarray(ids[:, :length])
        mask = (ids > 0).astype(np.float32)
        picks = cache.indices([q["img_id"] for q in chunk])
        host = [torch.from_numpy(a) for a in (ids.astype(np.int64), picks,
                                                mask)]
        if pin:
            host = [t.pin_memory() for t in host]
        return chunk[:n_valid], host

    if buckets:
        # tokenize once at L, route each question to the smallest bucket
        # holding its token count, and slice the padded rows
        bucket_lens = sorted({min(int(b), L) for b in buckets.split(",")
                              if b})
        if bucket_lens[-1] < L:
            bucket_lens.append(L)
        full_ids = tokenizer.encode_batch([q["sent"] for q in questions], L)
        lengths = (full_ids > 0).sum(axis=1)
        by_bucket: Dict[int, List[int]] = {b: [] for b in bucket_lens}
        for i, n_tok in enumerate(lengths):
            by_bucket[next(b for b in bucket_lens if n_tok <= b)].append(i)
        all_batches = []
        for b in bucket_lens:
            idxs = by_bucket[b]
            all_batches.extend(
                build_batch([questions[i] for i in idxs[s:s + B]], B,
                            length=b, ids_rows=full_ids[idxs[s:s + B]])
                for s in range(0, len(idxs), B))
        print("buckets: " + ", ".join(f"L={b}: {len(by_bucket[b])}"
                                      for b in bucket_lens))
        # the longest batch first: it absorbs the warm-up
        all_batches.sort(key=lambda t: -t[1][0].shape[1])
    else:
        all_batches = [build_batch(questions[s:s + B], B)
                       for s in range(0, len(questions), B)]

    if bf16:
        from xlxmert_tpu_torch.models.lxmert import ServingOptions
        from xlxmert_tpu_torch.models.task_heads import vqa_model

        model = vqa_model(params, cfg, len(label2ans), dtype=torch.bfloat16,
                          options=ServingOptions(True, attention, fused_ffn),
                          device=dev)
        n_calib_batches = 0
        run = bf16_serving_forward(model, cache, dev)
        path = "bf16"
    else:
        qp = engine.prepare_params(params["bert"], cfg, dev)
        hqp = engine.prepare_answer_head(params["answer_head"], dev)
        n_calib = min(calib_samples, len(questions))
        calib_idx = np.random.RandomState(0).choice(
            len(questions), size=n_calib, replace=False)
        calib_qs = [questions[i] for i in calib_idx]
        Bc = 8
        calib_pos = pos[None].expand(Bc, V, 4)
        calib_batches = []
        for s in range(0, n_calib, Bc):
            _, (c_ids, c_picks, c_mask) = build_batch(calib_qs[s:s + Bc],
                                                      Bc)
            c_feats = FeatureCache.lookup(cache.table,
                                          c_picks.to(dev)).float()
            calib_batches.append((c_ids.to(dev), c_feats, calib_pos,
                                  c_mask.to(dev)))
        print(f"calibrating int8 scales on {len(calib_batches)} batches "
              f"({n_calib} queries sampled across the stream)")
        engine.calibrate(qp, hqp, calib_batches, cfg)
        engine.apply_calibration(qp, hqp)
        engine.assert_fully_calibrated(qp, hqp)
        n_calib_batches = len(calib_batches)
        del calib_batches
        if on_calibrated is not None:
            on_calibrated()
        if fused:
            from xlxmert_tpu_torch.serving.lxmert_fused import prepare_fused

            qp = prepare_fused(qp, cfg)
            run = fused_serving_forward(qp, hqp, cache, cfg, dev)
            path = "int8_fused"
        else:
            run = serving_forward(qp, hqp, cache, cfg, dev)
            path = "int8_static"
    n = 0
    pending: deque = deque()
    t_begin = time.time()
    tracing = contextlib.ExitStack()
    with open(output, "w") as f, tracing:
        def write(chunk, preds):
            for q, p in zip(chunk, preds.tolist()):
                f.write(json.dumps({"question_id": q["question_id"],
                                    "answer": label2ans[int(p)]}) + "\n")

        if profile and len(all_batches) == 1:
            tracing.enter_context(trace(profile))
        # warm-up batch runs synchronously; the steady-state clock starts
        # before the remaining batches are dispatched
        chunk0, host0 = all_batches[0]
        write(chunk0, run(*host0).cpu())
        if profile and len(all_batches) > 1:
            print(f"profiler trace of {len(all_batches) - 1} batches -> "
                  f"{profile}")
            tracing.enter_context(trace(profile))
        t0 = time.time()
        for chunk, host in all_batches[1:]:
            pending.append((chunk, run(*host)))
            if len(pending) > window:
                c, d = pending.popleft()
                write(c, d.cpu())
                n += len(c)
        while pending:
            c, d = pending.popleft()
            write(c, d.cpu())
            n += len(c)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t_end = time.time()
    total_qps = len(questions) / max(t_end - t_begin, 1e-9)
    steady_qps = n / max(t_end - t0, 1e-9) if n else None
    if n:
        print(f"served {len(questions)} answers ({path}, {dev.type});"
              f" steady-state {steady_qps:.1f} q/s, total wall-clock "
              f"{total_qps:.1f} q/s (incl. warm-up)")
    else:
        print(f"served {len(questions)} answers ({path}, {dev.type});"
              f" total wall-clock {total_qps:.1f} q/s")
    return {"answers": len(questions),
            "forwards": n_calib_batches + len(all_batches),
            "calib_forwards": n_calib_batches,
            "serve_forwards": len(all_batches),
            "steady_qps": steady_qps, "total_qps": total_qps,
            "engine": model if bf16 else (qp, hqp)}



def main(argv=None):
    ns = parse_args(argv)

    from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.data.io import GridFeatureReader, load_json
    from xlxmert_tpu_torch.data.fast_tokenizer import FastTokenizer
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.utils.device import resolve_device

    dev = resolve_device(ns.device)
    cfg = (LxmertConfig.from_yaml(ns.model_config) if ns.model_config
           else LxmertConfig())
    label2ans = load_json(ns.label2ans)
    tokenizer = FastTokenizer(ns.vocab)
    with open(ns.questions) as f:
        questions = [json.loads(line) for line in f if line.strip()]
    print(f"{len(questions)} questions")
    if not questions:
        open(ns.output, "w").close()
        print("served 0 answers")
        return ns.output

    # only the images --questions references go to the card, read
    # through: no second copy in host RAM
    with GridFeatureReader(ns.h5, cache=None) as reader:
        referenced = sorted({str(q["img_id"]) for q in questions})
        missing = [i for i in referenced if i not in reader]
        if missing:
            raise SystemExit(
                f"{len(missing)} img_id(s) in --questions are absent from "
                f"the --h5 catalog (first few: {missing[:5]})")
        t0 = time.time()
        cache = FeatureCache.build(reader, referenced, device=dev)
    print(f"feature cache: {cache.table.shape[0]} referenced images, "
          f"{cache.nbytes/1e6:.0f} MB on {dev}, {time.time()-t0:.1f}s")

    params = load_any_checkpoint(ns.load)
    params = params.get("params", params)
    serve(questions, tokenizer, cache, params, cfg, label2ans, ns.output,
          batch=ns.batch, max_text_length=ns.max_text_length,
          buckets=ns.buckets, window=ns.window,
          calib_samples=ns.calib_samples, device=dev, bf16=ns.bf16,
          profile=ns.profile)
    return ns.output


if __name__ == "__main__":
    main()
