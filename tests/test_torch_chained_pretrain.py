"""PretrainEngine.chained_train_step in the port: k chained steps against
k sequential train_step calls (bit for bit on the CPU, in both modes:
one placed batch, and place_stacked's per-step batches), and against the
JAX package's chained_train_step(per_step_batches=True) on host-masked
batches at dropout 0: the mean loss to 1e-3 relative and the parameters
within 6 * lr absolute, the bars of
tests/test_torch_pretrain.py::test_six_step_round_robin_trajectory_matches_jax."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_pretrain import CENTROIDS, LR, engines, flat, make_batch
from xlxmert_tpu.parallel.mesh import replicate
from xlxmert_tpu.tasks import pretrain as jpre

K = 3


@pytest.fixture(scope="module")
def setup():
    return engines()


def moments(state):
    return {n: (state.opt.m[n], state.opt.v[n]) for n in state.opt.m}


@pytest.mark.parametrize("per_step_batches", [False, True])
def test_chained_steps_equal_sequential_steps_bit_for_bit(setup,
                                                          per_step_batches):
    _, teng, params = setup
    cent = torch.from_numpy(CENTROIDS)
    host = [make_batch(20 + i) for i in range(K)]
    if not per_step_batches:
        host = [host[0]] * K
    task = "vis_mask" if per_step_batches else "word_mask"
    seq = teng.create_state(4, params)
    losses = [teng.train_step(seq, b, task, cent)["total_loss"]
              for b in host]
    chained = teng.create_state(4, params)
    fn = teng.chained_train_step(task, K, per_step_batches)
    batch = (teng.place_stacked(host) if per_step_batches
             else teng.place(host[0]))
    if per_step_batches:
        assert all(t.shape[0] == K for t in batch.values())
    out, mean = fn(chained, batch, cent)
    assert out is chained and chained.step == seq.step == K
    assert mean.dim() == 0 and torch.equal(mean, torch.stack(losses).mean())
    got, want = flat(chained.params()), flat(seq.params())
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert chained.opt.count == seq.opt.count
    for n, (m, v) in moments(seq).items():
        cm, cv = moments(chained)[n]
        assert torch.equal(m, cm) and torch.equal(v, cv), n
    # the generator was reseeded at every step, as train_step reseeds it
    assert torch.equal(chained.generator.get_state(),
                       seq.generator.get_state())


def test_chained_steps_match_the_jax_chained_step(setup):
    jeng, teng, params = setup
    task = "vis_mask"
    host = [make_batch(30 + i) for i in range(K)]
    jstate = replicate(jpre.TrainState.create(
        jax.tree.map(jnp.asarray, params), jeng.tx), jeng.mesh)
    jstate, jmean = jeng.chained_train_step(task, K, per_step_batches=True)(
        jstate, jeng.place_stacked(host), jax.random.PRNGKey(5),
        jnp.asarray(CENTROIDS))
    tstate = teng.create_state(0, params)
    tstate, tmean = teng.chained_train_step(task, K, per_step_batches=True)(
        tstate, teng.place_stacked(host), torch.from_numpy(CENTROIDS))
    np.testing.assert_allclose(float(tmean), float(jmean), rtol=1e-3)
    final = flat(jax.device_get(jstate.params))
    got = flat(tstate.params())
    assert got.keys() == final.keys()
    for key in final:
        np.testing.assert_allclose(got[key], final[key], atol=6 * LR,
                                   rtol=0, err_msg=key)
    assert int(np.asarray(jstate.step)) == tstate.step == K


def test_chained_step_rejects_k_below_one(setup):
    with pytest.raises(ValueError):
        setup[1].chained_train_step("matched", 0)
