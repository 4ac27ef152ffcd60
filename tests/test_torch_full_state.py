"""Pre-training's full-state checkpoint in the port
(`core/checkpoint.train_state_to_tree`, `restore_train_state`,
`AsyncCheckpointer.save_full`) on the CPU at tests/test_torch_pretrain's
small config: k steps + save_full + a fresh state's restore + k more
steps equal 2k straight steps bit for bit (on-device masks and dropout:
the generator is reseeded from the seed and the step); a FULL written by
the JAX package restores in the port leaf for leaf and its next step
lies within test_torch_pretrain's tolerances of the JAX step (loss 1e-5
relative, parameters 6 lr); a port FULL restores in the JAX package's
restore_train_state with every leaf equal; another config is refused."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fid import share_the_cores_and_blas  # noqa: F401
from test_torch_pretrain import (
    CENTROIDS, CFG_KW, LR, TOTAL_STEPS, engines, flat, make_batch, train_kw,
)
from xlxmert_tpu.core import checkpoint as jckpt
from xlxmert_tpu.parallel.mesh import replicate
from xlxmert_tpu.tasks import pretrain as jpre
from xlxmert_tpu_torch.core import checkpoint as ckpt
from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
from xlxmert_tpu_torch.tasks import pretrain as tpre

K = 3
pytestmark = pytest.mark.usefixtures("share_the_cores_and_blas")
MASKS = ("masked_word_id", "word_label", "vis_mask")


def leaves_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def dropout_engine():
    cfg = LxmertConfig(**dict(CFG_KW, hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1))
    return tpre.PretrainEngine(TrainConfig(**train_kw()), model_cfg=cfg,
                               total_steps=TOTAL_STEPS, device="cpu")


def steps(eng, state, first, n):
    cent = torch.from_numpy(CENTROIDS)
    out = []
    for k in range(first, first + n):
        # no host masks: the step draws them (and dropout) on the device
        batch = {key: v for key, v in make_batch(20 + k).items()
                 if key not in MASKS}
        m = eng.train_step(state, batch, eng.task_for_step(k), cent)
        out.append(float(m["total_loss"]))
    return out


def test_resumed_run_is_bit_equal_to_the_uninterrupted_run(tmp_path):
    eng = dropout_engine()
    params = eng.init_params(0)
    straight = eng.create_state(4, params)
    want = steps(eng, straight, 0, 2 * K)

    first = eng.create_state(4, params)
    got = steps(eng, first, 0, K)
    writer = ckpt.AsyncCheckpointer()
    full, lxrt = str(tmp_path / "Epoch01_FULL.msgpack"), str(
        tmp_path / "Epoch01_LXRT.msgpack")
    writer.save_full(ckpt.train_state_to_tree(first, TOTAL_STEPS), full,
                     lxrt)
    writer.wait()
    leaves_equal(ckpt.load_pytree(lxrt), ckpt.load_pytree(full)["params"])
    # a fresh engine and state from other weights and another generator
    # position: the restore replaces all of it
    eng2 = dropout_engine()
    resumed = eng2.create_state(4, eng2.init_params(1))
    assert ckpt.restore_train_state(resumed, full) == TOTAL_STEPS
    assert resumed.step == K and resumed.opt.sched_step == K
    got += steps(eng2, resumed, K, K)
    assert got == want
    leaves_equal(ckpt.train_state_to_tree(resumed),
                 ckpt.train_state_to_tree(straight))


@pytest.fixture(scope="module")
def jax_one_step():
    """The JAX engine and the port's engine on the same weights, and the
    JAX state after one host-masked vis_mask step (the parameters that
    task misses keep count 0: the counts differ per leaf)."""
    jeng, teng, params = engines()
    jstate = replicate(jpre.TrainState.create(
        jax.tree.map(jnp.asarray, params), jeng.tx), jeng.mesh)
    jstate, _ = jeng.train_step("vis_mask")(
        jstate, jeng.place(make_batch(10)), jax.random.PRNGKey(5),
        jnp.asarray(CENTROIDS))
    return jeng, teng, params, jstate


def test_a_jax_full_restores_in_the_port_and_steps_as_jax(jax_one_step,
                                                          tmp_path):
    jeng, teng, params, jstate = jax_one_step
    path = str(tmp_path / "Epoch01_FULL.msgpack")
    jckpt.save_pytree(jckpt.train_state_to_tree(jstate, TOTAL_STEPS), path)
    tstate = teng.create_state(0, params)
    assert ckpt.restore_train_state(tstate, path) == TOTAL_STEPS
    saved = ckpt.load_pytree(path)
    del saved["total_steps"]
    leaves_equal(ckpt.train_state_to_tree(tstate), saved)
    assert {int(c) for c in flat(saved["opt_state"]["count"]).values()} == {
        0, 1}
    # the next step from the restored state on both sides (the same task:
    # the JAX step is compiled once)
    batch = make_batch(12)
    jnext, jm = jeng.train_step("vis_mask")(
        jstate, jeng.place(batch), jax.random.PRNGKey(5),
        jnp.asarray(CENTROIDS))
    tm = teng.train_step(tstate, batch, "vis_mask",
                         torch.from_numpy(CENTROIDS))
    np.testing.assert_allclose(float(tm["total_loss"]),
                               float(jm["total_loss"]), rtol=1e-5)
    want, got = flat(jax.device_get(jnext.params)), flat(tstate.params())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=6 * LR, rtol=0,
                                   err_msg=k)
    assert tstate.opt.sched_step == 2 and tstate.step == 2


def test_a_port_full_restores_in_the_jax_package(jax_one_step, tmp_path):
    from flax import serialization

    jeng, teng, params, _ = jax_one_step
    tstate = teng.create_state(0, params)
    cent = torch.from_numpy(CENTROIDS)
    for k in range(2):
        teng.train_step(tstate, make_batch(10 + k), teng.task_for_step(k),
                        cent)
    path = str(tmp_path / "Epoch01_FULL.msgpack")
    ckpt.save_pytree(ckpt.train_state_to_tree(tstate, 99), path)
    fresh = replicate(jpre.TrainState.create(
        jax.tree.map(jnp.asarray, params), jeng.tx), jeng.mesh)
    restored, total = jckpt.restore_train_state(fresh, path)
    assert total == 99
    leaves_equal(jax.tree.map(np.asarray, serialization.to_state_dict(
        jax.device_get(jckpt.train_state_to_tree(restored)))),
        ckpt.train_state_to_tree(tstate))


def test_restore_refuses_another_config():
    teng = tpre.PretrainEngine(TrainConfig(**train_kw()),
                               model_cfg=LxmertConfig(**CFG_KW),
                               total_steps=TOTAL_STEPS, device="cpu")
    params = teng.init_params(0)
    tree = ckpt.train_state_to_tree(teng.create_state(0, params))
    other = tpre.PretrainEngine(
        TrainConfig(**train_kw()),
        model_cfg=LxmertConfig(**dict(CFG_KW, intermediate_size=64)),
        total_steps=TOTAL_STEPS, device="cpu")
    with pytest.raises(ValueError, match="full-state checkpoint: .*shape"):
        ckpt.restore_train_state(other.create_state(0), tree)
    del tree["opt_state"]["sched_step"]
    with pytest.raises(ValueError, match="full-state checkpoint: /opt_state"):
        ckpt.restore_train_state(teng.create_state(0, params), tree)
