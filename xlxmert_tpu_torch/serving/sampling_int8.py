"""Int8 text-to-image sampling (port of xlxmert_tpu/serving/sampling_int8.py):
the NAR and AR decode loops through the static-calibrated int8 engine.

Every dense product of a decode step, the visual-cluster head's
transform -> linear_feat -> centroid logits included, is the int8 dense
kernel (ops/int8_matmul.py) with a calibrated activation scale, and
every attention is the packed-head kernel `mha_blhd` (fast=True), as in
the VQA engine (serving/lxmert_int8.py). The head's (hidden ->
num_clusters) weight is the centroid table, quantized once: the
reference's out_cluster weight is tied to it (modeling.py:140-151).

Semantics are tasks/sampling.py's, with two serving refinements of the
JAX package:
  - cells are ranked by their max log-probability (max logit -
    logsumexp) instead of a softmax over the clusters: the same order
    (a monotone map), and the returned probability is exp(logp);
  - the language stack runs once per batch, outside the decode loop (the
    text is fixed across steps; only the cross layers mix modalities).
A decode step also skips the language side of the last cross layer and
the pooler, which nothing after them reads (the JAX package's compiled
loop drops them as dead code); calibration runs the whole forward, so
every site gets the scale the JAX package gives it.

The cluster logits come out of the int8 dense in bf16 and are compared
in fp32: ties at the maximum among the clusters are common, and argmax
takes the first, as jnp.argmax does.

On CUDA the NAR sampler's whole call (language stack, loop state and
every decode step: ~2,650 launches at B=64 and full width) is one CUDA
graph per batch shape, captured at its first call and replayed after:
the host then spends a copy-in, a graph launch and the output clones a
call instead of every launch (`_NarGraph`). The CPU runs the call
eagerly.

Calibration: `sampling_calibration_batches` builds code grids at the
mask ratios the decode loop visits (step 0 all mask_feat, later steps
mostly committed centroids), so the static scales cover the whole
trajectory.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops._build import add_launches, launch_counts
from xlxmert_tpu_torch.ops.quant import quantize_weight
from xlxmert_tpu_torch.serving import lxmert_int8 as engine
from xlxmert_tpu_torch.serving.lxmert_int8 import (
    LayerNorm, LxmertInt8, _qw, calibrate_forward, cross_encode,
    lang_encode, layer_norm, visn_encode,
)
from xlxmert_tpu_torch.tasks.sampling import (
    StepHook, check_strategy, commit, commit_cells, grid_positions,
    remask_by_rank, step_cells,
)
from xlxmert_tpu_torch.utils.device import resolve_device
from xlxmert_tpu_torch.utils.profiling import count, span


class ObjHeadInt8(nn.Module):
    """The visual-cluster head: transform (int8) -> tanh gelu -> LN ->
    linear_feat (int8) -> cluster logits (int8, the centroid table)."""

    def __init__(self, oh: Dict, centroids: np.ndarray):
        super().__init__()
        self.transform = _qw(oh["transform"], "dense")
        self.ln = LayerNorm(oh["transform"]["LayerNorm"])
        self.linear_feat = _qw(oh, "linear_feat")
        self.cluster = quantize_weight(
            np.asarray(centroids, np.float32).T,
            np.asarray(oh["out_cluster_bias"], np.float32))


class SamplerInt8(nn.Module):
    """The int8 sampler tree: `bert` (the engine), `obj_head` and the
    bf16 `mask_feat` buffer."""

    def __init__(self, xlx_params: Dict, cfg: LxmertConfig,
                 centroids: np.ndarray):
        super().__init__()
        self.bert = LxmertInt8(xlx_params["bert"], cfg)
        self.obj_head = ObjHeadInt8(xlx_params["obj_predict_head"],
                                    centroids)
        self.register_buffer("mask_feat", torch.from_numpy(np.array(
            xlx_params["mask_feat"], np.float32)).to(torch.bfloat16))


def prepare_sampler_params(xlx_params: Dict, cfg: LxmertConfig,
                           centroids: np.ndarray,
                           device="cuda") -> SamplerInt8:
    """XLxmert flax tree (numpy leaves: "bert", "obj_predict_head",
    "mask_feat") -> the int8 sampler tree on `device`."""
    return SamplerInt8(xlx_params, cfg, centroids).to(
        resolve_device(device)).eval()


def obj_head_forward(ohp: ObjHeadInt8, visn: torch.Tensor) -> torch.Tensor:
    """(B, V, H) -> (B, V, num_clusters) fp32 cluster logits."""
    h = F.gelu(ohp.transform(visn), approximate="tanh")
    feat = ohp.linear_feat(layer_norm(h, ohp.ln))
    return ohp.cluster(feat).float()


def cross_layer(p, lang, visn, lang_bias, visn_bias, n_heads: int,
                lang_side: bool = True):
    """One cross-modality layer (serving/lxmert_int8.cross_encode's body)
    -> (lang, visn). With lang_side False only what the visual side
    reads is computed (the language side's kv), and lang comes back
    unchanged."""
    lang_kv = p.cross.kv(lang)
    if lang_side:
        new_lang = p.cross(lang, p.cross.kv(visn), visn_bias, n_heads)
    visn = p.visn_ffn(p.visn_self(p.cross(visn, lang_kv, lang_bias,
                                          n_heads), visn_bias, n_heads))
    if lang_side:
        lang = p.lang_ffn(p.lang_self(new_lang, lang_bias, n_heads))
    return lang, visn


def _encode_from_lang(sp: SamplerInt8, lang, lang_bias, feats, pos,
                      n_heads: int) -> torch.Tensor:
    """Visual stack + cross layers -> the final visual hidden states
    (B, V, H), from the language stack's output (lang_encode, once per
    batch). The last cross layer's language side is not computed."""
    visn, visn_bias = visn_encode(sp.bert, feats, pos, None, n_heads)
    return _cross_layers(sp, lang, visn, lang_bias, visn_bias, n_heads)


def _cross_layers(sp: SamplerInt8, lang, visn, lang_bias, visn_bias,
                  n_heads: int) -> torch.Tensor:
    """The cross layers of a decode step -> the final visual hidden
    states; the last layer's language side is not computed."""
    last = len(sp.bert.x_layers) - 1
    for j, p in enumerate(sp.bert.x_layers):
        lang, visn = cross_layer(p, lang, visn, lang_bias, visn_bias,
                                 n_heads, j < last)
    return visn


def _predict_from_lang(sp: SamplerInt8, lang, lang_bias, feats, pos,
                       n_heads: int) -> torch.Tensor:
    """A decode step's prediction: visual stack + cross layers + head."""
    visn = _encode_from_lang(sp, lang, lang_bias, feats, pos, n_heads)
    return obj_head_forward(sp.obj_head, visn)


def _predict_forward(sp: SamplerInt8, input_ids, feats, pos, mask,
                     n_heads: int) -> torch.Tensor:
    lang, lang_bias = lang_encode(sp.bert, input_ids, mask, n_heads)
    return _predict_from_lang(sp, lang, lang_bias, feats, pos, n_heads)


def sampling_calibration_batches(sp: SamplerInt8, centroids, input_ids,
                                 mask, grid_size: int = 8, seed: int = 0):
    """Batches of (ids, feats, pos, mask) covering the decode loop's
    input distribution: all-masked (step 0), half- and mostly-committed.
    The same numpy draws as the JAX package's."""
    n_cells = grid_size * grid_size
    B, dev = input_ids.shape[0], input_ids.device
    pos = grid_positions(grid_size, B, dev, torch.bfloat16)
    rng = np.random.RandomState(seed)
    table = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
    ids = rng.randint(0, table.shape[0], (B, n_cells))
    codes = table[torch.from_numpy(ids).to(dev)].to(torch.bfloat16)
    mask_feat = sp.mask_feat[None, None, :]
    out = []
    for frac in (1.0, 0.5, 0.1):
        m = torch.from_numpy(rng.rand(B, n_cells) < frac).to(
            dev, torch.bfloat16)[..., None]
        out.append((input_ids, m * mask_feat + (1 - m) * codes, pos, mask))
    return out


def calibrate_sampler(sp: SamplerInt8, centroids, input_ids, mask,
                      cfg: LxmertConfig, grid_size: int = 8
                      ) -> Dict[str, float]:
    """Static-scale calibration over the sampling input distribution,
    through the whole forward (language, visual and cross stacks, pooler,
    cluster head). Returns {site name: amax}; apply_calibration(sp)
    then gives each site its scale."""
    batches = sampling_calibration_batches(sp, centroids, input_ids, mask,
                                           grid_size)
    n_heads = cfg.num_attention_heads

    def forward(sp_, ids, feats, pos, m):
        lang, lang_bias = lang_encode(sp_.bert, ids, m, n_heads)
        visn, visn_bias = visn_encode(sp_.bert, feats, pos, None, n_heads)
        _, visn, _ = cross_encode(sp_.bert, lang, visn, lang_bias,
                                  visn_bias, n_heads)
        obj_head_forward(sp_.obj_head, visn)

    return calibrate_forward(forward, (sp,), batches)


def _log_prob_max(logits: torch.Tensor):
    """(max log-probability, argmax) per cell: max logit - logsumexp."""
    return (torch.exp(logits.amax(-1) - torch.logsumexp(logits, -1)),
            logits.argmax(-1))


def _start(sp: SamplerInt8, centroids, input_ids, attention_mask,
           n_cells: int, grid_size: int, n_heads: int):
    pos = grid_positions(grid_size, input_ids.shape[0], input_ids.device,
                         torch.bfloat16)
    return _begin(sp, centroids, input_ids, attention_mask, n_cells, pos,
                  n_heads)


def _begin(sp: SamplerInt8, centroids, input_ids, attention_mask,
           n_cells: int, pos, n_heads: int):
    """_start with the grid's positions given: the loop's state and the
    language stack, with no copy from the host."""
    B, dev = input_ids.shape[0], input_ids.device
    table = centroids.to(torch.bfloat16)
    code = torch.zeros(B, n_cells, table.shape[1], dtype=torch.bfloat16,
                       device=dev)
    ids = torch.zeros(B, n_cells, dtype=torch.long, device=dev)
    lang, lang_bias = lang_encode(sp.bert, input_ids, attention_mask,
                                  n_heads)
    return table, pos, code, ids, lang, lang_bias


def _nar_call(sp: SamplerInt8, centroids, input_ids, attention_mask, pos,
              n_steps: int, n_heads: int, on_step: StepHook = None):
    """One call of the int8 NAR sampler, eager (make_nar_sampler_int8's
    body on the CPU, and what it captures on CUDA): the language stack
    and the loop's state, then `n_steps` decode steps over the grid
    positions `pos` (B, V, 4) bf16. -> (code, ids, prob)."""
    n_cells = pos.shape[1]
    with span("xlt.sampler.language"):
        table, pos, code, ids, lang, lang_bias = _begin(
            sp, centroids, input_ids, attention_mask, n_cells, pos, n_heads)
        prob = torch.zeros(ids.shape, device=ids.device)
    mask_feat = sp.mask_feat[None, None, :]
    for i in range(n_steps):
        with span("xlt.sampler.remask"):
            vis_mask = remask_by_rank(prob, ((n_steps - i) * n_cells)
                                      // n_steps)
            feats = torch.where(vis_mask[..., None], mask_feat, code)
        with span("xlt.sampler.visual"):
            visn, visn_bias = visn_encode(sp.bert, feats, pos, None,
                                          n_heads)
        with span("xlt.sampler.cross"):
            visn = _cross_layers(sp, lang, visn, lang_bias, visn_bias,
                                 n_heads)
        with span("xlt.sampler.head"):
            logits = obj_head_forward(sp.obj_head, visn)
        if on_step is not None:
            on_step(i, {"feats": feats, "vis_mask": vis_mask}, logits)
        with span("xlt.sampler.commit"):
            prob, pred_id = _log_prob_max(logits)
            code = torch.where(vis_mask[..., None],
                               F.embedding(pred_id, table), code)
            ids = torch.where(vis_mask, pred_id, ids)
    return code, ids, prob


# the counters (utils/profiling.count) of the NAR sampler's CUDA graphs
GRAPHS_CAPTURED = "xlt.sampler.graphs_captured"
GRAPH_REPLAYS = "xlt.sampler.graph_replays"


def _engine_state():
    """What the engine's module switches and calibration bake into a
    captured call: the scales and the attention route."""
    return (engine.calibration_version(), engine._ATTENTION_IMPL,
            engine._INT8_ATTENTION, engine._attention_core)


class _NarGraph:
    """One NAR call (`_nar_call`) captured as a CUDA graph for one batch
    shape, tree, centroid table and engine state, and replayed.

    Capture: an eager warm-up on a side stream (the kernels' first-use
    set-up), then the call on static inputs, its grid positions built
    once beforehand (a copy from the host cannot be captured). With
    `keep_steps` each step's feats, vis_mask and logits stay in buffers
    of their own. The kernels' launch counts come back to what they
    were: a replay adds the launches the capture made.

    A call copies the inputs in, replays, and hands back clones of the
    outputs and of the kept steps, so nothing the caller holds changes
    at the next replay."""

    def __init__(self, sp, centroids, input_ids, attention_mask,
                 n_steps: int, grid_size: int, n_heads: int,
                 keep_steps: bool):
        # what the graph reads and writes stays alive with it: the tree's
        # weights, the static inputs and positions, the kept steps
        self.sp = sp
        self.device = input_ids.device
        self.input_ids = input_ids.clone()
        self.attention_mask = attention_mask.clone()
        self.pos = grid_positions(grid_size, input_ids.shape[0], self.device,
                                  torch.bfloat16)
        self.steps = []

        def keep(i, inputs, logits):
            self.steps.append((inputs["feats"], inputs["vis_mask"], logits))

        def call(hook):
            return _nar_call(sp, centroids, self.input_ids,
                             self.attention_mask, self.pos, n_steps,
                             n_heads, hook)

        before = launch_counts()
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call(None)
            torch.cuda.current_stream().wait_stream(side)
            warm = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = call(keep if keep_steps else None)
        made = launch_counts()
        self.launches = {k: n - warm.get(k, 0) for k, n in made.items()}
        add_launches({k: before.get(k, 0) - n for k, n in made.items()})
        count(GRAPHS_CAPTURED)

    def __call__(self, input_ids, attention_mask, on_step: StepHook):
        with span("xlt.sampler.replay"), torch.cuda.device(self.device):
            self.input_ids.copy_(input_ids)
            self.attention_mask.copy_(attention_mask)
            self.graph.replay()
            add_launches(self.launches)
            out = tuple(t.clone() for t in self.out)
            steps = [tuple(t.clone() for t in step) for step in self.steps]
        count(GRAPH_REPLAYS)
        for i, (feats, vis_mask, logits) in enumerate(steps):
            on_step(i, {"feats": feats, "vis_mask": vis_mask}, logits)
        return out


def make_nar_sampler_int8(cfg: LxmertConfig, n_steps: int,
                          grid_size: int = 8, on_step: StepHook = None):
    """The int8 NAR mask-predict sampler.

    Returns fn(sp, centroids, input_ids, attention_mask)
      -> (code (B,V,D) bf16, cluster_ids (B,V) int64, prob (B,V) fp32)
    with the commit/re-mask semantics of tasks/sampling.make_nar_sampler
    (reference imggen_model.py:169-257).

    On the CPU a call runs eagerly (`_nar_call`). Its stages are spans
    (utils/profiling): "xlt.sampler.language" (the language stack and
    the loop's state), then each step's "xlt.sampler.remask",
    "xlt.sampler.visual", "xlt.sampler.cross", "xlt.sampler.head" and
    "xlt.sampler.commit"; `on_step` runs between the head and the
    commit, outside every span.

    On CUDA the whole call is one CUDA graph (`_NarGraph`), captured at
    the first call of each batch shape (B, L) and input types, tree `sp`,
    centroid table (its storage) and engine state (calibration_version,
    the attention route), and replayed at the next ones: the stages'
    spans fire only at a capture; a call is the span
    "xlt.sampler.replay" (copy-in, replay, the clones), and the
    counters GRAPHS_CAPTURED and GRAPH_REPLAYS count. `on_step` runs
    after the replay, for each step in order, with clones of the step's
    feats, vis_mask and logits (the values it gets on the CPU).
    """
    n_heads = cfg.num_attention_heads
    graphs: Dict = {}

    @torch.inference_mode()
    def sample(sp, centroids, input_ids, attention_mask):
        if input_ids.device.type != "cuda":
            pos = grid_positions(grid_size, input_ids.shape[0],
                                 input_ids.device, torch.bfloat16)
            return _nar_call(sp, centroids, input_ids, attention_mask, pos,
                             n_steps, n_heads, on_step)
        key = (tuple(input_ids.shape), input_ids.dtype,
               tuple(attention_mask.shape), attention_mask.dtype,
               input_ids.device, id(sp),
               centroids.data_ptr(), tuple(centroids.shape),
               centroids.stride(), centroids.dtype, _engine_state())
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = _NarGraph(
                sp, centroids, input_ids, attention_mask, n_steps,
                grid_size, n_heads, on_step is not None)
        return graph(input_ids, attention_mask, on_step)

    return sample


def make_ar_sampler_int8(cfg: LxmertConfig, grid_size: int = 8,
                         strategy: str = "confidence",
                         n_steps: Optional[int] = None,
                         selective_head: bool = False,
                         on_step: StepHook = None):
    """The int8 AR sampler (reference imggen_model.py:49-167, semantics
    of tasks/sampling.make_ar_sampler): one cell committed per step over
    n_steps (default grid_size**2) forwards from one language stack.

    strategy in {"confidence", "TLBR", "order"}; "order" consumes a
    caller-provided position array.

    selective_head (TLBR and order only, default off): these strategies
    commit exactly the current cell, so the cluster head runs on that one
    cell instead of all of them. The head is ~2.9 of the ~13 GOP a
    sample a step at full width (transform 75M + linear_feat 201M +
    2,048 x 10,000 logits 2.6G); the commits are bit-identical, as the
    int8 products are exact and each row is quantized alone. The
    confidence strategy needs every unvisited cell's probability and
    keeps the full head. Off by default, as in the JAX package; its time
    on the H100 is not measured yet.

    Returns fn(sp, centroids, input_ids, attention_mask, positions=None)
      -> (code, cluster_ids).
    """
    check_strategy(strategy)
    selective = selective_head and strategy in ("TLBR", "order")
    n_cells = grid_size * grid_size
    n_steps = n_steps or n_cells
    n_heads = cfg.num_attention_heads

    @torch.inference_mode()
    def sample(sp, centroids, input_ids, attention_mask, positions=None):
        cells = step_cells(strategy, positions, n_steps, n_cells)
        table, pos, code, ids, lang, lang_bias = _start(
            sp, centroids, input_ids, attention_mask, n_cells, grid_size,
            n_heads)
        vis_mask = torch.ones(ids.shape, device=ids.device)
        visited = torch.zeros(ids.shape, device=ids.device)
        mask_feat = sp.mask_feat[None, None, :]
        for i in range(n_steps):
            if cells is not None:
                vis_mask[:, cells[i]] = 1.0
            feats = torch.where(vis_mask[..., None] > 0, mask_feat, code)
            pred_prob = None
            if selective:
                visn = _encode_from_lang(sp, lang, lang_bias, feats, pos,
                                         n_heads)
                cur = cells[i]
                logits = obj_head_forward(
                    sp.obj_head, visn[:, cur:cur + 1].contiguous())
                pred_id = logits.argmax(-1).expand(ids.shape)
            else:
                logits = _predict_from_lang(sp, lang, lang_bias, feats,
                                            pos, n_heads)
                if strategy == "confidence":
                    pred_prob, pred_id = _log_prob_max(logits)
                else:
                    pred_id = logits.argmax(-1)
            if on_step is not None:
                on_step(i, {"feats": feats, "vis_mask": vis_mask > 0},
                        logits)
            update = commit_cells(cells, i, pred_prob, visited)
            code, ids, vis_mask, visited = commit(
                update, F.embedding(pred_id, table), pred_id, code, ids,
                vis_mask, visited)
        return code, ids

    return sample

