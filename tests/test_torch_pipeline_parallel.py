"""The port's GPipe pipeline (parallel/pipeline.py) on 4 ranks over gloo
on the CPU: forward and gradients at (data 2, pipe 2) and (data 1,
pipe 4), M = 4 microbatches, against the JAX package's pipeline_apply
on the same mesh shapes and its sequential stack, at the JAX test's
bars (tests/test_pipeline.py: rtol/atol 2e-5 forward, rtol 5e-4 /
atol 1e-6 gradients); and stack_language_layers' path contract."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_pipeline import CFG, L, _setup
import torch_rank_bodies as bodies
from xlxmert_tpu.parallel.mesh import make_mesh
from xlxmert_tpu.parallel.pipeline import pipeline_apply, place_pipeline
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.core.convert import flax_to_state_dict
from xlxmert_tpu_torch.parallel.launch import spawn
from xlxmert_tpu_torch.parallel.pipeline import (
    stack_language_layers, stack_layers,
)

SPAWN_TIMEOUT = 150
SHAPES = ((2, 2), (1, 4))
N_MICRO = 4
MODEL_KW = dict(vocab_size=64, hidden_size=16, num_attention_heads=2,
                intermediate_size=32, l_layers=8, x_layers=1, r_layers=1,
                visual_feat_dim=8, num_clusters=0)


def _torch_layer(tree, i):
    return {k: v for k, v in flax_to_state_dict(
        jax.tree.map(lambda a: np.asarray(a[i]), tree)).items()}


@pytest.fixture(scope="module")
def pipe_run():
    layer_fn, stacked, x0, bias, sequential = _setup()
    per_layer = [_torch_layer(stacked, i) for i in range(L)]
    st = {k: np.stack([p[k].numpy() for p in per_layer])
          for k in per_layer[0]}
    calls = [("pipeline_run", dict(model_kw=MODEL_KW, stacked=st,
                                   x0=np.asarray(x0), bias=np.asarray(bias),
                                   mesh_shape=s, n_micro=N_MICRO))
             for s in SHAPES]
    ranks = spawn(bodies.cases, 4, (calls,), timeout=SPAWN_TIMEOUT,
                  device="cpu")
    return dict(layer_fn=layer_fn, stacked=stacked, x0=x0, bias=bias,
                sequential=sequential, ranks=ranks)


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_pipeline_matches_jax_and_the_sequential_stack(pipe_run, case):
    d, s = SHAPES[case]
    stacked, x0, bias = pipe_run["stacked"], pipe_run["x0"], pipe_run["bias"]
    ref = np.asarray(pipe_run["sequential"](stacked, x0))
    mesh = make_mesh((d, s), ("data", "pipe"), jax.devices()[:d * s])
    lp, c = place_pipeline(stacked, (x0, bias), mesh)
    jout = np.asarray(jax.jit(lambda lp, c: pipeline_apply(
        pipe_run["layer_fn"], lp, c, mesh=mesh, n_micro=N_MICRO))(lp, c)[0])
    results = [r[case] for r in pipe_run["ranks"]]
    B = ref.shape[0] // d
    for r in results:                 # every stage returns the output
        rows = slice(r["data"] * B, (r["data"] + 1) * B)
        np.testing.assert_allclose(r["h"], ref[rows], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["h"], jout[rows], rtol=2e-5,
                                   atol=2e-5)
        assert r["pipe_stats"]["stage_ticks"] == N_MICRO
        assert r["pipe_stats"]["ticks"] == N_MICRO + s - 1

    def loss(st):
        return (pipe_run["sequential"](st, x0) ** 2).mean()

    ref_g = jax.grad(loss)(stacked)

    def pipe_loss(lp):
        h, _ = pipeline_apply(pipe_run["layer_fn"], lp, c, mesh=mesh,
                              n_micro=N_MICRO)
        return (h ** 2).mean()

    jax_g = jax.jit(jax.grad(pipe_loss))(lp)
    got = {}
    for r in results:
        if r["data"] == 0:
            got.update(r["grads"])
    for want in (ref_g, jax_g):
        for i in range(L):
            for k, v in _torch_layer(want, i).items():
                np.testing.assert_allclose(got[f"{i}.{k}"], v.numpy(),
                                           rtol=5e-4, atol=1e-6,
                                           err_msg=f"{i}.{k}")
    # data ranks average their gradients: both hold the same
    if d > 1:
        other = [r for r in results if r["data"] == 1]
        for r in other:
            for k, v in r["grads"].items():
                np.testing.assert_array_equal(v, got[k])


def test_stack_language_layers_path_contract():
    from xlxmert_tpu_torch.models.lxmert import LxmertModel

    model = LxmertModel(LxmertConfig(**MODEL_KW))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    stacked = stack_language_layers(model, MODEL_KW["l_layers"])
    assert stacked.keys() == model.encoder.layer[0].state_dict().keys()
    for i in range(MODEL_KW["l_layers"]):
        for k, v in model.encoder.layer[i].state_dict().items():
            assert stacked[k][i].data_ptr() != v.data_ptr()
            assert torch.equal(stacked[k][i], v)
    assert all(v.shape[0] == MODEL_KW["l_layers"]
               for v in stack_layers(list(model.encoder.layer)).values())
