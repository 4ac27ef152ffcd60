"""Text-to-image sampling CLI on the GPU (port of
xlxmert_tpu/cli/sample_images.py; reference scripts/sample_images.sh +
src/tasks/sample_images.py:27-104, which as shipped has a SyntaxError:
this implements the unambiguous intent).

    python -m xlxmert_tpu_torch.cli.sample_images \\
        --load snap/pretrained/x_lxmert/Epoch20_LXRT.msgpack \\
        --centroids data/cluster_centroids/maskrcnn_..._grid8.npy \\
        --generator snap/pretrained/G_60.msgpack \\
        --sentences example_sentences.txt --sample_steps 4 \\
        --output samples [--int8] [--device cuda] [--profile DIR]

Each batch of sentences goes through the NAR (mask-predict) or AR code
sampler (tasks/sampling.py; with --int8 serving/sampling_int8.py), then,
with --generator, the SPADE generator's render (models/gan.py, bf16) to
PNGs; without it the cluster ids are saved as .npy. `sample_images()` is
that loop, callable with the loaded inputs (`load_inputs`); it returns
the ids, codes, images and per-batch times.

--profile DIR traces the batches after the first one (the only batch,
if there is one) with torch.profiler into DIR, a Chrome trace for
TensorBoard/Perfetto (utils/profiling.trace) in which the stages are
ranges beside the card's kernels: with --int8 and NAR the sampler's
"xlt.sampler.language" and each decode step's "xlt.sampler.remask",
"xlt.sampler.visual", "xlt.sampler.cross", "xlt.sampler.head" and
"xlt.sampler.commit"; the render's "xlt.render" in every mode.
"""
from __future__ import annotations

import argparse
import contextlib
import struct
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

KEEP = ("bert", "obj_predict_head", "mask_feat")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", required=True, help="X-LXMERT checkpoint "
                   "(.pth or .msgpack)")
    p.add_argument("--centroids", default=None,
                   help="centroid .npy (falls back to vis_emb in the ckpt)")
    p.add_argument("--generator", default=None,
                   help="generator checkpoint (G_60.pth or .msgpack); "
                   "omit to dump code grids without rendering")
    p.add_argument("--vocab", default="data/vocab.txt")
    p.add_argument("--sentences", default="example_sentences.txt")
    p.add_argument("--output", default="samples")
    p.add_argument("--sample_steps", type=int, default=4)
    p.add_argument("--sample_mode", choices=["NAR", "AR"], default="NAR")
    p.add_argument("--save_intermediate", action="store_true",
                   help="NAR only: also render the grid after every "
                   "mask-predict step (imggen_model.py:245-248)")
    p.add_argument("--position_strategy", default="confidence",
                   choices=["confidence", "TLBR", "random"])
    p.add_argument("--int8", action="store_true",
                   help="run the decode loop (NAR and AR) through the "
                   "static-calibrated int8 engine (serving/"
                   "sampling_int8.py: int8 dense and packed-head attention "
                   "kernels); calibrated on sentences drawn across the "
                   "whole stream")
    p.add_argument("--fast_render", action="store_true",
                   help="capped-modulation SPADE render (models/gan.py "
                   "mod_cap=32): the gamma/beta convolutions at no more "
                   "than 32x32, their maps upsampled")
    p.add_argument("--grid_size", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_text_length", type=int, default=20)
    p.add_argument("--target_size", type=int, default=256)
    p.add_argument("--g_base_dim", type=int, default=32)
    p.add_argument("--codebook_dim", type=int, default=256)
    p.add_argument("--seed", type=int, default=9595)
    p.add_argument("--model_config", default=None,
                   help="LxmertConfig yaml (defaults to full size)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu, where every kernel "
                   "takes its plain PyTorch version")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the batches after the first one with "
                   "torch.profiler into DIR, a Chrome trace for "
                   "TensorBoard/Perfetto whose ranges are the sampler's "
                   "and the render's stages")
    return p.parse_args(argv)


def load_inputs(ns) -> Dict:
    """Read what `ns` names: the X-LXMERT tree ("bert",
    "obj_predict_head", "mask_feat"), the centroid table (fp32 numpy),
    the LxmertConfig sized to it, the tokenizer, the sentences and, with
    --generator, the generator's (params, sn, batch_stats)."""
    from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.data.tokenization import Tokenizer

    t0 = time.time()
    ckpt = load_any_checkpoint(ns.load)
    if ns.centroids:
        centroids = np.load(ns.centroids)
    elif "vis_emb" in ckpt:
        centroids = np.asarray(ckpt["vis_emb"]["embedding"])
    else:
        raise SystemExit("--centroids required (checkpoint has no vis_emb)")
    centroids = np.ascontiguousarray(centroids, np.float32)
    n_clusters, feat_dim = centroids.shape
    if ns.model_config:
        cfg = LxmertConfig.from_yaml(ns.model_config).replace(
            num_clusters=n_clusters, visual_feat_dim=feat_dim)
    else:
        cfg = LxmertConfig(num_clusters=n_clusters, visual_feat_dim=feat_dim)
    params = {k: v for k, v in ckpt.items() if k in KEEP}
    print(f"loaded checkpoint in {time.time() - t0:.1f}s")
    with open(ns.sentences) as f:
        sentences = [line.strip() for line in f if line.strip()]
    print(f"{len(sentences)} sentences")
    generator = (split_generator_ckpt(load_any_checkpoint(ns.generator))
                 if ns.generator else None)
    return {"params": params, "centroids": centroids, "cfg": cfg,
            "tokenizer": Tokenizer(ns.vocab), "sentences": sentences,
            "generator": generator}


def split_generator_ckpt(ckpt):
    """Return (params, sn, batch_stats) from either a native generator
    checkpoint (top-level variable collections) or a converted torch
    tree (spectral-norm u/v inline as weight_u/weight_v)."""
    if "params" in ckpt and set(ckpt) <= {"params", "sn", "batch_stats"}:
        return (ckpt.get("params", {}), ckpt.get("sn", {}),
                ckpt.get("batch_stats", {}))
    from xlxmert_tpu_torch.core.convert import split_variables

    cols = split_variables(ckpt)
    return (cols.get("params", {}), cols.get("sn", {}),
            cols.get("batch_stats", {}))


def calibration_ids(sentences, tokenizer, batch_size: int,
                    max_text_length: int) -> np.ndarray:
    """One batch of sentences drawn evenly across the whole stream (not
    the first batch, whose scales would clip later atypical prompts),
    padded with empty sentences."""
    idx = np.linspace(0, len(sentences) - 1,
                      num=min(len(sentences), batch_size), dtype=int)
    picked = [sentences[i] for i in idx]
    return tokenizer.encode_batch(picked + [""] * (batch_size - len(picked)),
                                  max_text_length)


def build_sampler(ns, inputs, dev, on_step=None):
    """(the sampler `ns` asks for, as fn(ids, mask, order) -> (code, ids)
    or, NAR, (code, ids, prob); its engine: the calibrated int8 tree with
    --int8, else the bf16 model)."""
    import torch

    cfg, params = inputs["cfg"], inputs["params"]
    centroids = torch.from_numpy(inputs["centroids"]).to(dev)
    strategy = ("order" if ns.position_strategy == "random"
                else ns.position_strategy)
    if ns.int8:
        from xlxmert_tpu_torch.serving.lxmert_int8 import (
            apply_calibration, assert_fully_calibrated,
        )
        from xlxmert_tpu_torch.serving.sampling_int8 import (
            calibrate_sampler, make_ar_sampler_int8, make_nar_sampler_int8,
            prepare_sampler_params,
        )

        ids0 = calibration_ids(inputs["sentences"], inputs["tokenizer"],
                               ns.batch_size, ns.max_text_length)
        ids0 = torch.from_numpy(ids0.astype(np.int64)).to(dev)
        sp = prepare_sampler_params(params, cfg, inputs["centroids"], dev)
        calibrate_sampler(sp, centroids, ids0, (ids0 > 0).float(), cfg,
                          ns.grid_size)
        apply_calibration(sp)
        assert_fully_calibrated(sp)
        print("int8 serving path calibrated")
        if ns.sample_mode == "NAR":
            sampler = make_nar_sampler_int8(cfg, ns.sample_steps,
                                            ns.grid_size, on_step=on_step)
        else:
            sampler = make_ar_sampler_int8(cfg, ns.grid_size, strategy,
                                           on_step=on_step)
        engine, head = sp, (sp,)
    else:
        from xlxmert_tpu_torch.tasks.sampling import (
            make_ar_sampler, make_nar_sampler, sampler_model,
        )

        model = sampler_model(params, cfg, torch.bfloat16, dev)
        if ns.sample_mode == "NAR":
            sampler = make_nar_sampler(
                model, ns.sample_steps, ns.grid_size,
                collect_intermediate=ns.save_intermediate, on_step=on_step)
        else:
            sampler = make_ar_sampler(model, ns.grid_size, strategy,
                                      on_step=on_step)
        engine, head = model, ()

    def run(ids, mask, order=None):
        if order is not None:
            return sampler(*head, centroids, ids, mask, order)
        return sampler(*head, centroids, ids, mask)

    return run, engine


def build_renderer(ns, inputs, dev):
    """The bf16 SPADE generator of `ns`'s sizes (--fast_render: mod_cap
    32) with the checkpoint's params and sn, or None without one. It
    normalizes per instance, as the JAX CLI's, and reads no batch
    statistics."""
    import torch

    from xlxmert_tpu_torch.models.gan import Generator, load_variables

    if inputs["generator"] is None:
        return None
    g_params, g_sn, _ = inputs["generator"]
    gen = Generator(emb_dim=inputs["centroids"].shape[1],
                    base_dim=ns.g_base_dim, target_size=ns.target_size,
                    init_H=ns.grid_size, init_W=ns.grid_size,
                    codebook_dim=ns.codebook_dim, dtype=torch.bfloat16,
                    mod_cap=32 if ns.fast_render else None)
    return load_variables(gen, g_params, g_sn).to(dev).eval()


def sample_images(ns, inputs: Dict, on_ready: Optional[Callable] = None,
                  on_step=None) -> Dict:
    """Sample every sentence of inputs["sentences"] in batches of
    ns.batch_size, render with the generator (if any) and write the
    outputs to ns.output. `on_ready` is called once the sampler (and its
    int8 calibration) is ready, before the first batch; `on_step` is
    passed to the sampler (tasks/sampling.py). Returns "ids" (N, V) and
    "codes" (N, V, D, on the device) of the final grids, "images" (N, S,
    S, 3) float32 in [0, 1] or None, per batch "sample_s" and "render_s"
    (host clock, each ended by a synchronize), the "engine" (the
    calibrated int8 tree or the bf16 model) and "generator" it ran, and
    "graphs": the int8 NAR sampler's CUDA graphs captured and replayed
    (utils/profiling's counters, recorded for the run and printed at its
    end; none off the card).
    ns.profile, a directory, traces the batches after the first one
    into it (utils/profiling.trace; the first where it is the only
    one)."""
    import torch

    from xlxmert_tpu_torch.models.gan import render
    from xlxmert_tpu_torch.serving.sampling_int8 import (
        GRAPH_REPLAYS, GRAPHS_CAPTURED,
    )
    from xlxmert_tpu_torch.utils import profiling
    from xlxmert_tpu_torch.utils.device import resolve_device
    from xlxmert_tpu_torch.utils.profiling import trace

    if ns.int8 and ns.save_intermediate:
        raise SystemExit("--int8 does not support --save_intermediate")
    dev = resolve_device(ns.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run, engine = build_sampler(ns, inputs, dev, on_step)
    gen = build_renderer(ns, inputs, dev)
    if on_ready is not None:
        on_ready()
    tokenizer, sentences = inputs["tokenizer"], inputs["sentences"]
    out_dir = Path(ns.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    B = ns.batch_size
    rng = np.random.RandomState(ns.seed)
    all_ids, all_codes, all_imgs = [], [], []
    sample_s, render_s = [], []
    profile_from = B if len(sentences) > B else 0
    tracing = contextlib.ExitStack()
    counted = profiling.counts()
    if not profiling.recording():   # the counters for this run alone
        profiling.enable()
        tracing.callback(profiling.drain)
        tracing.callback(profiling.disable)
    with tracing:
        for s in range(0, len(sentences), B):
            if ns.profile and s == profile_from:
                print(f"profiler trace of the batches from sentence {s} -> "
                      f"{ns.profile}")
                tracing.enter_context(trace(ns.profile))
            batch_sents = sentences[s:s + B]
            n = len(batch_sents)
            ids = tokenizer.encode_batch(batch_sents + [""] * (B - n),
                                         ns.max_text_length)
            ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
            mask_t = (ids_t > 0).float()
            order = (rng.permutation(ns.grid_size ** 2)
                     if ns.sample_mode == "AR"
                     and ns.position_strategy == "random" else None)
            t0 = time.perf_counter()
            code, cluster_ids = run(ids_t, mask_t, order)[:2]
            sync()
            dt = time.perf_counter() - t0
            sample_s.append(dt)
            steps = None
            if ns.sample_mode == "NAR" and ns.save_intermediate:
                # collect_intermediate: leading (n_steps,) axis; final = last
                steps, code, cluster_ids = code, code[-1], cluster_ids[-1]
            print(f"sampled {n} grids in {dt:.2f}s ({n / dt:.1f} samples/s)")
            all_ids.append(cluster_ids[:n].cpu().numpy())
            all_codes.append(code[:n])
            if gen is not None:
                t0 = time.perf_counter()
                imgs = render(gen, code).float()
                sync()
                render_s.append(time.perf_counter() - t0)
                imgs = imgs[:n].cpu().numpy()
                all_imgs.append(imgs)
                save_pngs(imgs, batch_sents, out_dir, s)
                for t in range(0 if steps is None else steps.shape[0]):
                    step_dir = out_dir / f"step{t}"
                    step_dir.mkdir(exist_ok=True)
                    save_pngs(render(gen, steps[t]).float()[:n].cpu().numpy(),
                              batch_sents, step_dir, s)
            else:
                np.save(out_dir / f"codes_{s:04d}.npy", all_ids[-1])
    now = profiling.counts()
    graphs = {k: now.get(k, 0) - counted.get(k, 0)
              for k in (GRAPHS_CAPTURED, GRAPH_REPLAYS)}
    print(f"outputs in {out_dir}")
    print(f"sampler graphs: {graphs[GRAPHS_CAPTURED]} captured, "
          f"{graphs[GRAPH_REPLAYS]} replayed")
    return {"ids": np.concatenate(all_ids) if all_ids else None,
            "codes": torch.cat(all_codes) if all_codes else None,
            "images": np.concatenate(all_imgs) if all_imgs else None,
            "sample_s": sample_s, "render_s": render_s, "engine": engine,
            "generator": gen, "graphs": graphs}


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (standard library only)."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_pngs(imgs, sentences, out_dir: Path, offset: int):
    for i, (img, sent) in enumerate(zip(imgs, sentences)):
        arr = (img * 255).astype(np.uint8)
        name = "".join(c if c.isalnum() or c == " " else "" for c in sent)
        name = "_".join(name.split())[:60] or f"sample_{offset + i}"
        with open(out_dir / f"{offset + i:04d}_{name}.png", "wb") as f:
            f.write(png_bytes(arr))


def main(argv=None):
    ns = parse_args(argv)
    return sample_images(ns, load_inputs(ns))


if __name__ == "__main__":
    main()
