"""Rank bodies of the port's multi-process CPU tests: each runs on one
rank of a `parallel/launch.spawn`, drives the port's distributed path at
the small sizes it is given and returns numpy results for the test to
hold against a single process and the JAX package. It imports no JAX: a
spawned rank re-imports this module.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Sequence

import numpy as np
import torch


def cases(rank: int, calls: Sequence) -> List[Any]:
    """Several rank bodies in one spawn: [(name, kwargs), ...] run in
    order, their results in a list."""
    return [globals()[name](rank, **kw) for name, kw in calls]


def run_cli(rank: int, module: str, argv: Sequence[str]) -> Any:
    """A CLI's `main(argv)` on this rank, as torchrun would start it: the
    CLI starts the process group from the launch's environment. Its
    RunLogger writes no TensorBoard events here (importing TensorBoard
    may load TensorFlow, seconds a rank)."""
    import importlib
    import sys

    sys.modules["torch.utils.tensorboard"] = None
    return importlib.import_module(module).main(list(argv))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def pretrain_steps(rank: int, model_kw: Dict, train_kw: Dict,
                   batches: Sequence[Dict], tasks: Sequence[str],
                   centroids: np.ndarray, mesh_shape, axis_names,
                   params: Dict, total_steps: int = 100,
                   device: str = "cpu") -> Dict[str, Any]:
    """PretrainEngine on the mesh (mesh_shape over axis_names) from the
    flax tree `params`: one train_step of
    tasks[i] on each global batch's data slice. Returns every step's
    metrics and collective counters, on rank 0 the gathered parameters,
    on every rank its replicated parameters."""
    from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.parallel.sharding import lxmert_param_spec
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    cfg = TrainConfig(**train_kw, mesh_shape=tuple(mesh_shape),
                      mesh_axis_names=tuple(axis_names))
    eng = PretrainEngine(cfg, LxmertConfig(**model_kw),
                         total_steps=total_steps, device=device)
    state = eng.create_state(0, params=params)
    cents = torch.from_numpy(np.asarray(centroids, np.float32)).to(eng.device)
    out: Dict[str, Any] = {"steps": []}
    for b, task in zip(batches, tasks):
        local = pmesh.shard_batch(b, eng.mesh, process_local=False)
        pmesh.reset_comm()
        m = eng.train_step(state, local, task, cents)
        out["steps"].append({"task": task,
                             "metrics": {k: float(v) for k, v in m.items()},
                             "comm": dict(pmesh.COMM)})
    full = state.params()          # gathered over the model group
    if rank == 0:
        out["params"] = full
    out["replicated"] = {n: _np(p) for n, p in
                         state.model.named_parameters()
                         if lxmert_param_spec(n, p.dim()) is None}
    return out


def finetune_steps(rank: int, model_kw: Dict, ft_kw: Dict, task: str,
                   n_answers: int, params: Dict, batches: Sequence[Dict],
                   total_steps: int, device: str = "cpu") -> Dict[str, Any]:
    """FinetuneEngine over every rank on "data": each global batch's data
    slice through train_step, gated by should_update. Returns the
    metrics of each step and, on rank 0, the parameters; every rank a
    checksum of its parameters."""
    from xlxmert_tpu_torch.core.config import FinetuneConfig, LxmertConfig
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.finetune import (
        FinetuneEngine, should_update,
    )

    cfg = FinetuneConfig(task=task, **ft_kw)
    eng = FinetuneEngine(cfg, n_answers, LxmertConfig(**model_kw),
                         total_steps=total_steps, device=device)
    state = eng.create_state(0, params=params)
    steps = []
    for i, b in enumerate(batches):
        local = pmesh.shard_batch(b, eng.mesh, process_local=False)
        m = eng.train_step(state, local,
                           should_update(i, len(batches), cfg.update_freq))
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    flat = torch.cat([p.detach().reshape(-1) for p in
                      state.model.parameters()])
    return {"steps": steps, "params": state.params() if rank == 0 else None,
            "checksum": hashlib.sha1(_np(flat).tobytes()).hexdigest()}


def predict_merge(rank: int, model_kw: Dict, ft_kw: Dict, task: str,
                  n_answers: int, params: Dict, batches: Sequence[Dict],
                  shard_dir: str, int8: bool = False,
                  device: str = "cpu") -> Dict[Any, Any]:
    """FinetuneEngine.predict on this rank's round-robin batches, merged
    through `shard_dir`."""
    from xlxmert_tpu_torch.core.config import FinetuneConfig, LxmertConfig
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine

    eng = FinetuneEngine(FinetuneConfig(task=task, **ft_kw), n_answers,
                         LxmertConfig(**model_kw), device=device)
    state = eng.create_state(0, params=params)
    world = pmesh.world_size()
    mine = [dict(b) for i, b in enumerate(batches) if i % world == rank]
    return eng.predict(state.model, mine, int8=int8, shard_dir=shard_dir)


def replicated_module(rank: int) -> Dict[str, np.ndarray]:
    """A module whose weights differ by rank, after `replicate` over
    every rank on "data": the first rank's everywhere."""
    from xlxmert_tpu_torch.parallel import mesh as pmesh

    m = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(float(rank + 1))
    pmesh.replicate(m, pmesh.make_mesh())
    return {n: _np(p) for n, p in m.named_parameters()}


def gan_steps(rank: int, gan_kw: Dict, tree: Dict, batch: Dict,
              centroids: np.ndarray, device: str = "cpu") -> Dict[str, Any]:
    """GanEngine over every rank on "data" from the state tree `tree`
    (state_to_tree's layout): one D-step and one G-step on the global
    batch's data slice. Returns both steps' metrics and, on rank 0, the
    state tree after them; every rank its batch-norm running
    statistics."""
    from xlxmert_tpu_torch.core.config import GanConfig
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.train_generator import (
        GanEngine, restore_state, state_to_tree,
    )

    eng = GanEngine(GanConfig(**gan_kw), device=device)
    state = eng.create_state(0, centroids)
    restore_state(state, tree)
    table = torch.from_numpy(np.asarray(centroids, np.float32)).to(
        eng.device)
    local = eng.place(pmesh.shard_batch(batch, eng.mesh,
                                        process_local=False))
    state, dm = eng.d_step(state, local, table)
    state, gm = eng.g_step(state, local, table)
    stats = {n: _np(b) for n, b in state.G.named_buffers()
             if n.endswith(".mean") or n.endswith(".var")}
    return {"d": {k: float(v) for k, v in dm.items()},
            "g": {k: float(v) for k, v in gm.items()},
            "tree": state_to_tree(state) if rank == 0 else None,
            "stats": stats}


def pipeline_run(rank: int, model_kw: Dict, stacked: Dict[str, np.ndarray],
                 x0: np.ndarray, bias: np.ndarray, mesh_shape,
                 n_micro: int, device: str = "cpu") -> Dict[str, Any]:
    """The language layers `stacked` ((L, ...) state dicts of
    TransformerLayer) pipelined over a ("data", "pipe") mesh: this data
    rank's slice of (x0, bias) through pipeline_apply (eval-mode fp32
    layers), loss = mean(h^2) of the local output and its gradients
    averaged over the data group. Returns the output, this stage's
    gradients (keyed by global layer index) and the schedule's
    counts."""
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.models.lxmert import (
        EXACT, TrainOptions, TransformerLayer,
    )
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.parallel.pipeline import (
        PIPE_STATS, pipeline_apply, place_pipeline,
    )

    mesh = pmesh.make_mesh(tuple(mesh_shape), ("data", "pipe"))
    cfg = LxmertConfig(**model_kw)
    st = {k: torch.from_numpy(v) for k, v in stacked.items()}
    stage = place_pipeline(st, lambda: TransformerLayer(
        cfg, EXACT, TrainOptions()), mesh, device=device).eval()
    local = pmesh.shard_batch({"x": x0, "bias": bias}, mesh,
                              process_local=False)
    x = torch.from_numpy(local["x"]).to(device)
    b = torch.from_numpy(local["bias"]).to(device)

    def layer_fn(layer, carry):
        h, bb = carry
        return layer(h, bb), bb

    h, _ = pipeline_apply(layer_fn, stage, (x, b), mesh=mesh,
                          n_micro=n_micro)
    g = torch.autograd.grad((h ** 2).mean(), list(stage.parameters()))
    names = [n for n, _ in stage.named_parameters()]
    avg = pmesh.all_reduce_mean(dict(zip(names, g)), mesh.group("data"))
    first = mesh.index("pipe") * len(stage)
    grads = {}
    for n, v in avg.items():
        i, rest = n.split(".", 1)
        grads[f"{first + int(i)}.{rest}"] = _np(v)
    return {"stage": mesh.index("pipe"), "data": mesh.index("data"),
            "pipe_stats": dict(PIPE_STATS), "h": _np(h), "grads": grads}


def feature_table(rank: int, rows: np.ndarray, idx: np.ndarray,
                  device: str = "cpu") -> Dict[str, Any]:
    """A catalog of `rows` ((N, g, g, D)) in a FeatureCache sharded over
    every rank on "data", looked up at `idx`: the (B, V, D) result (bf16
    as fp32)."""
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

    class Reader:
        def get(self, i):
            return rows[int(i)]

    mesh = pmesh.make_mesh()
    cache = FeatureCache.build(Reader(), [str(i) for i in range(len(rows))],
                               device=device, mesh=mesh)
    picks = torch.from_numpy(cache.indices([str(i) for i in idx])).to(
        device)
    got = FeatureCache.lookup(cache.table, picks, cache.shard)
    return {"feats": _np(got), "rows_here": int(cache.table.shape[0])}
