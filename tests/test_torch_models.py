"""Port's LXMERT backbone and VQA model (models/, CPU) against the JAX
package's flax `LxmertModel` / `VQAModel` on the same parameters and
inputs: the exact fp32 path, serving mode on each attention route with
and without the fused FFN, the bf16 serving model as cli/serve builds
it, and the weight bridge in both directions."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import xlxmert_tpu.models.lxmert as jlx
from xlxmert_tpu.core.config import LxmertConfig as JaxConfig
from xlxmert_tpu.models.task_heads import VQAModel as JaxVQAModel
from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.core.convert import (
    convert_torch_state_dict, flax_to_state_dict,
)
from xlxmert_tpu_torch.models.lxmert import ServingOptions
from xlxmert_tpu_torch.models.task_heads import vqa_model

# the SMALL config of tests/test_lxmert_parity.py
SMALL = dict(vocab_size=111, hidden_size=48, num_attention_heads=4,
             intermediate_size=96, l_layers=2, x_layers=2, r_layers=2,
             visual_feat_dim=24, visual_pos_dim=4, num_qa_labels=17,
             num_clusters=50)
N_ANS = 13
# the JAX serving_mode attention names of the port's routes
JAX_ROUTE = {"einsum": "xla", "blhd": "pallas_blhd", "pallas": "pallas"}


def inputs(B=3, L=7, V=9, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, SMALL["vocab_size"], size=(B, L))
    ids[:, 0] = 1
    mask = np.ones((B, L), np.float32)
    mask[0, L - 2:] = 0.0  # padding on one row
    feats = rng.randn(B, V, SMALL["visual_feat_dim"]).astype(np.float32)
    pos = rng.rand(B, V, SMALL["visual_pos_dim"]).astype(np.float32)
    return ids, feats, pos, mask


@pytest.fixture(scope="module")
def params():
    """Flax VQAModel parameters (numpy), every leaf redrawn from a seed so
    biases and LayerNorm parameters are not the init's zeros and ones."""
    ids, feats, pos, mask = inputs()
    model = JaxVQAModel(JaxConfig(**SMALL), num_answers=N_ANS)
    tree = jax.jit(lambda k: model.init(k, ids, feats, pos,
                                        attention_mask=mask))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * noise
        return (0.05 if "kernel" in name or "embedding" in name
                else 0.02) * noise

    return jax.tree_util.tree_map_with_path(redraw, tree["params"])


def jax_forward(params, batch, dtype=jnp.float32):
    """(lang, visn, pooled, logits) of the flax VQAModel under the current
    serving_mode; the backbone's outputs are captured in the same pass."""
    model = JaxVQAModel(JaxConfig(**SMALL), num_answers=N_ANS, dtype=dtype)

    @jax.jit
    def fwd(p, ids, feats, pos, mask):
        logits, state = model.apply(
            {"params": p}, ids, feats, pos, attention_mask=mask,
            capture_intermediates=True, mutable=["intermediates"])
        return state["intermediates"]["bert"]["__call__"][0] + (logits,)

    return [np.asarray(a, np.float32) for a in fwd(params, *batch)]


def port_forward(model, batch):
    ids, feats, pos, mask = (torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        out = model.bert(ids, feats.to(model.dtype), pos,
                         attention_mask=mask)
        logits = model(ids, feats, pos, attention_mask=mask)
    return [t.float().numpy() for t in out + (logits,)]


def cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)


def test_exact_fp32_model_matches_jax(params):
    """serving=False: erf gelu, fp32 softmax, einsum attention; fp32 sums
    in another order (the tolerance of test_lxmert_parity.py)."""
    batch = inputs()
    ref = jax_forward(params, batch)
    model = vqa_model(params, LxmertConfig(**SMALL), N_ANS, device="cpu")
    got = port_forward(model, batch)
    for name, g, r in zip(("lang", "visn", "pooled", "logits"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("fused_ffn", [False, True])
@pytest.mark.parametrize("attention", ["einsum", "blhd", "pallas"])
def test_serving_mode_matches_jax(params, attention, fused_ffn):
    """serving_mode(True, attention, fused_ffn) in fp32 compute: tanh
    gelu, and the Pallas kernels in interpret mode against the port's
    plain versions; fp32 sums in another order."""
    batch = inputs(seed=2)
    try:
        jlx.serving_mode(True, attention=JAX_ROUTE[attention],
                         fused_ffn=fused_ffn)
        ref = jax_forward(params, batch)
    finally:
        jlx.serving_mode(False)
    model = vqa_model(params, LxmertConfig(**SMALL), N_ANS, device="cpu",
                      options=ServingOptions(True, attention, fused_ffn))
    got = port_forward(model, batch)
    for name, g, r in zip(("lang", "visn", "pooled", "logits"), got, ref):
        np.testing.assert_allclose(g, r, atol=2e-5, err_msg=name)


def test_bf16_serving_model_matches_jax(params):
    """The bf16 serving model as cli/serve --bf16 builds it: every float
    parameter cast to bf16, serving_mode(True) with "auto" attention
    (the einsum route on the CPU). The two frameworks round gelu, tanh
    and the fused elementwise chains at different points in bf16, so
    the bar is direction, not bits: cosine > 0.999 on the pooled output
    and the logits, and the same answer for 90 % of the questions."""
    batch = inputs(B=32, L=12, V=16, seed=3)
    bf16 = jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16),
                        params)
    try:
        jlx.serving_mode(True)
        _, _, pooled, logits = jax_forward(bf16, batch, dtype=jnp.bfloat16)
    finally:
        jlx.serving_mode(False)
    model = vqa_model(params, LxmertConfig(**SMALL), N_ANS, device="cpu",
                      dtype=torch.bfloat16, options=ServingOptions(True))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    _, _, t_pooled, t_logits = port_forward(model, batch)
    assert cos(t_pooled, pooled) > 0.999
    assert cos(t_logits, logits) > 0.999
    assert (t_logits.argmax(-1) == logits.argmax(-1)).mean() >= 0.9


def test_weights_round_trip_bit_exact(params):
    """flax tree -> port state_dict -> convert_torch_state_dict gives the
    tree back bit for bit, and every port parameter comes from the tree
    (the port keeps HF LXMERT's names, which convert_torch_state_dict
    maps to flax's; tests/test_lxmert_parity.py holds that map to HF)."""
    model = vqa_model(params, LxmertConfig(**SMALL), N_ANS, device="cpu")
    back = convert_torch_state_dict(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert set(flax_to_state_dict(params)) == set(model.state_dict())
    assert "bert.encoder.layer.1.attention.self.query.weight" in \
        model.state_dict()
