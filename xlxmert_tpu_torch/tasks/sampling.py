"""Text-to-image code samplers: NAR mask-predict and AR decoding loops
(port of xlxmert_tpu/tasks/sampling.py).

Reference: x-lxmert/src/tasks/imggen_model.py —
  - sample_image_NAR (:169-257): linear mask-count decay
    n_mask = ((n_steps - i) * 64) // n_steps; each step re-masks the
    n_mask lowest-probability cells, re-predicts the full grid, and
    commits predictions at masked positions.
  - sample_image_AR (:49-167): one grid cell committed per step; position
    strategies: max-confidence with a visited mask (:92-93,140-149),
    top-left-to-bottom-right (:106-107), or a given order (:78-90).

The JAX package's `lax.scan` / `fori_loop` is a Python loop here, under
`torch.inference_mode()`, over static shapes: a fixed grid, a fixed step
count, the "n lowest cells" taken by rank thresholding (a double stable
argsort) instead of a data-dependent top-k. The model is the port's
`XLxmert(cfg, dtype, heads=("obj",))` with the exact options (einsum
attention, fp32 softmax, erf gelu), as the JAX CLI runs it.

A sampler returns the final code grid (B, V, D) and the cluster ids
(B, V); rendering to pixels is the SPADE generator's job (models/gan.py).
`on_step`, where given, is called after each step's prediction with the
step's index, its model inputs and the cluster logits.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.models.xlxmert import XLxmert
from xlxmert_tpu_torch.utils.boxes import box_position

NEG = -10000.0  # the reference's masked_fill value (imggen_model.py:141-142)
STRATEGIES = ("confidence", "TLBR", "order")
StepHook = Optional[Callable[[int, Dict[str, torch.Tensor], torch.Tensor],
                             None]]


def nar_mask_counts(n_steps: int, n_cells: int):
    """The mask count of each NAR step, as the samplers compute it."""
    return [((n_steps - i) * n_cells) // n_steps for i in range(n_steps)]


def grid_positions(grid_size: int, batch: int, device,
                   dtype=torch.float32) -> torch.Tensor:
    """(batch, grid_size**2, 4) normalized cell boxes."""
    pos = torch.from_numpy(box_position(grid_size)).to(device, dtype)
    return pos[None].expand(batch, -1, -1)


def remask_by_rank(prob: torch.Tensor, n_mask: int) -> torch.Tensor:
    """Boolean (B, V): the n_mask cells of lowest prob per row, ties to
    the lower index (ranks by a double stable argsort, as jnp.argsort)."""
    order = torch.argsort(prob, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True) < n_mask


def check_strategy(strategy: str, positions_hint: str = "") -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}"
                         + positions_hint)


def order_positions(positions, n_steps: int, n_cells: int):
    """A caller's position order as Python ints wrapped into the grid
    (imggen_model.py:103); raises if it is shorter than n_steps."""
    pos = np.asarray(positions.cpu() if torch.is_tensor(positions)
                     else positions).reshape(-1)
    if pos.shape[0] < n_steps:
        raise ValueError(f"positions has {pos.shape[0]} entries for "
                         f"{n_steps} steps")
    return [int(p) % n_cells for p in pos[:n_steps]]


def _predict(model: XLxmert, input_ids, attention_mask, code, visual_pos,
             vis_mask, centroids):
    """One grid prediction: masked forward -> per-cell (best prob, id)
    and the cluster logits. Argmax ties take the first index."""
    logits = model(input_ids, code, visual_pos,
                   attention_mask=attention_mask, vis_mask=vis_mask,
                   centroids=centroids, heads=("obj",))["obj_logits"]
    probs = torch.softmax(logits.float(), dim=-1)
    return probs.amax(-1), probs.argmax(-1), logits


def make_nar_sampler(model: XLxmert, n_steps: int, grid_size: int = 8,
                     collect_intermediate: bool = False,
                     on_step: StepHook = None):
    """The NAR mask-predict sampler.

    Returns fn(centroids, input_ids, attention_mask)
      -> (code (B,V,D), cluster_ids (B,V) int64, pred_prob (B,V) fp32)
    on the model's device, code in the centroids' type. With
    collect_intermediate, code/ids gain a leading (n_steps,) axis — the
    per-step grids the reference renders when return_intermediate is set
    (imggen_model.py:245-248).
    """
    n_cells = grid_size * grid_size

    @torch.inference_mode()
    def sample(centroids, input_ids, attention_mask):
        B, dev = input_ids.shape[0], input_ids.device
        pos = grid_positions(grid_size, B, dev)
        # the tied cluster head reads the table in the compute type: cast
        # it once per batch instead of once per step
        table = centroids.to(model.dtype)
        code = torch.zeros(B, n_cells, centroids.shape[1],
                           dtype=centroids.dtype, device=dev)
        ids = torch.zeros(B, n_cells, dtype=torch.long, device=dev)
        # uniform initial "probabilities": step 0 masks all cells anyway
        prob = torch.zeros(B, n_cells, device=dev)
        codes, all_ids = [], []
        for i in range(n_steps):
            vis_mask = remask_by_rank(prob, ((n_steps - i) * n_cells)
                                      // n_steps)
            prob, pred_id, logits = _predict(
                model, input_ids, attention_mask, code, pos,
                vis_mask.float(), table)
            if on_step is not None:
                on_step(i, {"code": code, "vis_mask": vis_mask}, logits)
            code = torch.where(vis_mask[..., None],
                               F.embedding(pred_id, centroids), code)
            ids = torch.where(vis_mask, pred_id, ids)
            if collect_intermediate:
                codes.append(code)
                all_ids.append(ids)
        if collect_intermediate:
            return torch.stack(codes), torch.stack(all_ids), prob
        return code, ids, prob

    return sample


def make_ar_sampler(model: XLxmert, grid_size: int = 8,
                    strategy: str = "confidence",
                    n_steps: Optional[int] = None, on_step: StepHook = None):
    """The AR sampler. strategy in {"confidence", "TLBR", "order"};
    "order" consumes a caller-provided position array of at least
    n_steps entries (the reference's pre-shuffled `positions` list,
    imggen_model.py:78-90), wrapped into the grid.

    Returns fn(centroids, input_ids, attention_mask, positions=None)
      -> (code, cluster_ids).
    """
    check_strategy(strategy, " — the reference's random order is 'order' "
                   "with a shuffled positions array (imggen_model.py:78-90)")
    n_cells = grid_size * grid_size
    n_steps = n_steps or n_cells

    @torch.inference_mode()
    def sample(centroids, input_ids, attention_mask, positions=None):
        cells = step_cells(strategy, positions, n_steps, n_cells)
        B, dev = input_ids.shape[0], input_ids.device
        pos = grid_positions(grid_size, B, dev)
        table = centroids.to(model.dtype)
        code = torch.zeros(B, n_cells, centroids.shape[1],
                           dtype=centroids.dtype, device=dev)
        ids = torch.zeros(B, n_cells, dtype=torch.long, device=dev)
        vis_mask = torch.ones(B, n_cells, device=dev)
        visited = torch.zeros(B, n_cells, device=dev)
        for i in range(n_steps):
            if cells is not None:
                # re-mask the current cell (supports > n_cells steps,
                # imggen_model.py:101-105)
                vis_mask[:, cells[i]] = 1.0
            pred_prob, pred_id, logits = _predict(
                model, input_ids, attention_mask, code, pos, vis_mask, table)
            if on_step is not None:
                on_step(i, {"code": code, "vis_mask": vis_mask > 0}, logits)
            update = commit_cells(cells, i, pred_prob, visited)
            code, ids, vis_mask, visited = commit(
                update, F.embedding(pred_id, centroids), pred_id, code, ids,
                vis_mask, visited)
        return code, ids

    return sample


def step_cells(strategy: str, positions, n_steps: int, n_cells: int):
    """The cell each step commits for TLBR and order (Python ints), None
    for confidence."""
    if strategy == "order":
        if positions is None:
            raise ValueError("strategy 'order' needs a positions array")
        return order_positions(positions, n_steps, n_cells)
    if positions is not None:
        raise ValueError(f"strategy {strategy!r} takes no positions")
    if strategy == "TLBR":
        return [i % n_cells for i in range(n_steps)]
    return None


def commit_cells(cells, i: int, pred_prob: torch.Tensor,
                 visited: torch.Tensor) -> torch.Tensor:
    """Boolean (B, V) of the cell step i commits: the given cell, or
    (confidence) the most probable unvisited one, ties to the first."""
    if cells is not None:
        update = torch.zeros_like(visited, dtype=torch.bool)
        update[:, cells[i]] = True
        return update
    top = torch.where(visited > 0, NEG, pred_prob).argmax(-1)
    return F.one_hot(top, visited.shape[1]).bool()


def commit(update, pred_code, pred_id, code, ids, vis_mask, visited):
    """Write the committed cells' predictions, unmask and visit them."""
    code = torch.where(update[..., None], pred_code.to(code.dtype), code)
    ids = torch.where(update, pred_id, ids)
    u = update.to(vis_mask.dtype)
    return code, ids, vis_mask * (1.0 - u), torch.maximum(visited, u)


def sampler_model(params: Dict, cfg: LxmertConfig, dtype=torch.bfloat16,
                  device="cuda") -> XLxmert:
    """The X-LXMERT model the bf16 samplers run, from the flax tree's
    "bert", "obj_predict_head" and "mask_feat": the exact options, in
    eval mode, on `device`. The Dense and embedding weights are stored in
    the compute type (exact: every use casts them to it); LayerNorm
    parameters and mask_feat stay fp32."""
    from xlxmert_tpu_torch.core.convert import flax_to_state_dict
    from xlxmert_tpu_torch.models.lxmert import Dense, Embedding
    from xlxmert_tpu_torch.utils.device import resolve_device

    model = XLxmert(cfg, dtype, heads=("obj",))
    model.load_state_dict(flax_to_state_dict(
        {k: params[k] for k in ("bert", "obj_predict_head", "mask_feat")}))
    for m in model.modules():
        if isinstance(m, (Dense, Embedding)):
            m.to(dtype)
    return model.to(resolve_device(device)).eval()


def random_params(cfg: LxmertConfig, seed: int = 0) -> Dict:
    """A random X-LXMERT tree in the flax layout the samplers read:
    "bert" (serving/lxmert_int8.random_params), "obj_predict_head"
    (transform, linear_feat, out_cluster_bias) and "mask_feat". Made with
    numpy from `seed`."""
    from xlxmert_tpu_torch.serving.lxmert_int8 import random_params as rp

    bert, _ = rp(cfg, 2, seed)
    rng = np.random.default_rng(seed + 1)
    std = np.float32(cfg.initializer_range)
    H, Fv = cfg.hidden_size, cfg.visual_feat_dim

    def normal(*shape, scale=std):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    head = {"transform": {"dense": {"kernel": normal(H, H),
                                    "bias": normal(H)},
                          "LayerNorm": {"scale": 1.0 + normal(H),
                                        "bias": normal(H)}},
            "linear_feat": {"kernel": normal(H, Fv), "bias": normal(Fv)},
            "out_cluster_bias": normal(cfg.num_clusters)}
    return {"bert": bert, "obj_predict_head": head,
            "mask_feat": normal(Fv, scale=np.float32(0.1))}
