"""Port's legacy AdamW (`core/optim.py`) and the fine-tuning
accumulation (`tasks/finetune.accumulate_or_apply`) against the JAX
package's `reference_adamw` and `AccumTrainState`, on synthetic
gradients; and the no-decay split on the full VQAModel parameter list
against the JAX package's rule."""
import numpy as np

import jax
import jax.numpy as jnp
import optax
import torch

from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.core.optim import _is_no_decay
from xlxmert_tpu.core.optim import linear_warmup_decay as jax_schedule
from xlxmert_tpu.core.optim import make_optimizer as jax_make_optimizer
from xlxmert_tpu.models.task_heads import VQAModel as JaxVQAModel
from xlxmert_tpu.tasks.finetune import AccumTrainState
from xlxmert_tpu.tasks.finetune import should_update as jax_should_update
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.core.convert import convert_torch_state_dict
from xlxmert_tpu_torch.core.optim import (
    ReferenceAdamW, linear_warmup_decay, make_optimizer, no_decay,
)
from xlxmert_tpu_torch.models.task_heads import VQAModel
from xlxmert_tpu_torch.tasks.finetune import (
    accumulate_or_apply, should_update,
)

# torch names and their flax paths: a decayed kernel, a bias, a
# LayerNorm scale and bias, a LayerNorm outside a `LayerNorm` module
NAMES = {"dense.weight": ("dense", "kernel"),
         "dense.bias": ("dense", "bias"),
         "out.LayerNorm.weight": ("out", "LayerNorm", "scale"),
         "out.LayerNorm.bias": ("out", "LayerNorm", "bias"),
         "visn_layer_norm.weight": ("visn_layer_norm", "scale")}
SHAPES = {"dense.weight": (6, 5), "dense.bias": (5,),
          "out.LayerNorm.weight": (5,), "out.LayerNorm.bias": (5,),
          "visn_layer_norm.weight": (5,)}


def _tree(flat):
    out = {}
    for name, path in NAMES.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(flat[name])
    return out


def _leaf(tree, name):
    for p in NAMES[name]:
        tree = tree[p]
    return np.asarray(tree)


def test_schedule_matches_optax_in_float32():
    for total, ratio in ((37, 0.05), (12, 0.25), (5, 0.05)):
        jax_sched = jax.jit(jax_schedule(5e-5, total, ratio))
        ours = linear_warmup_decay(5e-5, total, ratio)
        for step in range(total + 3):
            assert ours(step) == np.float32(jax_sched(jnp.int32(step)))


def test_reference_adamw_matches_jax_with_clipping():
    """Six updates with clipping biting on some: parameters, moments and
    per-parameter counts as the JAX update gives them."""
    rng = np.random.RandomState(3)
    init = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    kw = dict(lr=3e-2, total_steps=10, warmup_ratio=0.2, weight_decay=0.05,
              clip_grad_norm=1.0)
    tx = jax_make_optimizer(kw["lr"], kw["total_steps"], kw["warmup_ratio"],
                            kw["weight_decay"], kw["clip_grad_norm"], 1e-6)
    jp = _tree(init)
    js = tx.init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    opt = make_optimizer(tp, kw["lr"], kw["total_steps"], kw["warmup_ratio"],
                         kw["weight_decay"], kw["clip_grad_norm"], 1e-6)
    for i in range(6):
        scale = 0.05 if i % 2 else 2.0      # the clip bites on even steps
        g = {n: (rng.randn(*s) * scale).astype(np.float32)
             for n, s in SHAPES.items()}
        upd, js = tx.update(_tree(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({n: torch.from_numpy(a) for n, a in g.items()})
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), _leaf(jp, n), rtol=2e-6,
                                   atol=1e-7, err_msg=n)
        np.testing.assert_allclose(opt.m[n].numpy(), _leaf(js.mu, n),
                                   rtol=2e-6, atol=1e-8, err_msg=n)
    assert set(opt.count.values()) == {6}
    assert {int(c) for c in jax.tree.leaves(js.count)} == {6}
    assert opt.sched_step == int(js.sched_step) == 6


def test_none_gradient_counts_as_zero():
    """A parameter the loss does not reach still advances: the JAX
    engine's dense gradient tree holds zeros there."""
    p = {"a.weight": torch.ones(2, 2), "b.weight": torch.ones(2, 2)}
    opt = ReferenceAdamW(p, 1e-2, 4, 0.25)
    for _ in range(3):
        opt.step({"a.weight": torch.full((2, 2), 0.5), "b.weight": None})
    assert opt.count == {"a.weight": 3, "b.weight": 3}
    # decayed from the second update on (the first has lr 0)
    assert float(p["b.weight"][0, 0]) < 1.0


def test_accumulation_matches_jax_accum_train_state():
    """update_freq=2 over 7 batches (updates at 2, 4 and the flush at 6)
    on synthetic gradients, with a near-eps leaf where Adam is linear in
    the accumulated gradient: a raw SUM and a MEAN differ there ~2x
    (tests/test_finetune_trajectory_parity.py:320-396). Clip off, as
    there, since clipping normalizes that difference away."""
    rng = np.random.RandomState(5)
    W = rng.randn(6, 5).astype(np.float32)
    t = (rng.randn(1, 4) * 1e-7).astype(np.float32)  # 2-D: a kernel
    jparams = {"dense": {"kernel": jnp.asarray(W)},
               "tiny": {"kernel": jnp.asarray(t)}}
    tx = jax_make_optimizer(1e-2, 10, warmup_ratio=0.2, weight_decay=0.013,
                            clip_grad_norm=None, adam_eps=1e-6)
    state = AccumTrainState.create(jparams, tx)
    tparams = {"dense.weight": torch.from_numpy(W.copy()),
               "tiny.weight": torch.from_numpy(t.copy())}
    opt = ReferenceAdamW(tparams, 1e-2, 10, 0.2, 0.013, None, eps=1e-6)
    acc = {n: torch.zeros_like(p) for n, p in tparams.items()}
    updates = []
    for i in range(7):
        gW = (rng.randn(6, 5) * 0.3).astype(np.float32)
        gt = (rng.randn(1, 4) * 1e-7).astype(np.float32)
        do_update = should_update(i, 7, 2)
        assert do_update == jax_should_update(i, 7, 2)
        updates.append(do_update)
        state = state.accumulate_or_apply(
            {"dense": {"kernel": jnp.asarray(gW)},
             "tiny": {"kernel": jnp.asarray(gt)}}, jnp.asarray(do_update))
        accumulate_or_apply(opt, acc, {"dense.weight": torch.from_numpy(gW),
                                       "tiny.weight": torch.from_numpy(gt)},
                            do_update)
    assert [i for i, u in enumerate(updates) if u] == [2, 4, 6]
    final = jax.device_get(state.params)
    np.testing.assert_allclose(tparams["dense.weight"].numpy(),
                               final["dense"]["kernel"], rtol=2e-6,
                               atol=2e-7)
    np.testing.assert_allclose(tparams["tiny.weight"].numpy(),
                               final["tiny"]["kernel"], rtol=1e-4,
                               atol=1e-10)
    assert set(opt.count.values()) == {3}
    assert all(float(a.abs().max()) == 0.0 for a in acc.values())


def test_no_decay_split_on_the_full_vqa_model_matches_jax():
    """Every parameter of the port's VQAModel, mapped to its flax path,
    takes the JAX package's decision; the LayerNorms outside a
    `LayerNorm` module are exempt, a substring rule would decay them."""
    small = dict(vocab_size=50, hidden_size=32, num_attention_heads=2,
                 intermediate_size=48, l_layers=2, x_layers=1, r_layers=1,
                 visual_feat_dim=16)
    model = VQAModel(LxmertConfig(**small), 7)
    sd = {n: p.detach() for n, p in model.named_parameters()}
    tree = convert_torch_state_dict(sd)
    jmodel = JaxVQAModel(JaxConfig(**small), num_answers=7)
    jtree = jax.eval_shape(lambda k: jmodel.init(
        k, jnp.ones((2, 5), jnp.int32), jnp.zeros((2, 4, 16)),
        jnp.zeros((2, 4, 4)), attention_mask=jnp.ones((2, 5))),
        jax.random.PRNGKey(0))["params"]
    assert jax.tree.structure(jtree) == jax.tree.structure(tree)
    jax_decision = {
        tuple(p.key for p in path): not _is_no_decay(path)
        for path, _ in jax.tree_util.tree_leaves_with_path(jtree)}
    opt = ReferenceAdamW(sd, 1e-3, 10)
    ours = {}
    for name, p in sd.items():
        node, path = convert_torch_state_dict({name: p}), []
        while isinstance(node, dict):
            (key, node), = node.items()
            path.append(key)
        ours[tuple(path)] = opt.decay[name]
        assert opt.decay[name] == (not no_decay(name, p.dim()))
    assert ours == jax_decision
    for name in ("bert.encoder.visn_fc.visn_layer_norm.weight",
                 "bert.encoder.visn_fc.box_layer_norm.weight",
                 "answer_head.logit_fc.2.weight",
                 "bert.embeddings.LayerNorm.weight",
                 "answer_head.logit_fc.3.bias"):
        assert not opt.decay[name], name
    for name in ("answer_head.logit_fc.3.weight",
                 "bert.embeddings.word_embeddings.weight",
                 "bert.encoder.layer.0.attention.self.query.weight"):
        assert opt.decay[name], name
