"""cli/train_generator in the port on the CPU (--device cpu): end to end
on tiny JPEGs, as tests/test_gan_cli.py runs the JAX CLI; --resume of a
G_{epoch}_FULL.msgpack that the JAX package wrote, then one more (D, G)
pair that equals the JAX engine's pair from the same state and batch
(the bars of tests/test_torch_gan_train.py); a FULL checkpoint that the
port wrote, restored by the JAX package's restore_state; and
chip_smoke's GAN phase (k) end to end at a tiny size.

The JAX FULL tree is built from the JAX engine's state with
serialization.to_state_dict and the JAX package's save_pytree, as its
CLI writes it, after one JAX pair (so Adam's count and moments are not
the init's) with the noise scales set back to 0: every forward of the
compared pair is noise-free (jax.random and a torch.Generator cannot
draw the same normals).
"""
import ast
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from xlxmert_tpu.core.checkpoint import restore_state as jax_restore_state
from xlxmert_tpu.core.checkpoint import save_pytree as jax_save_pytree
from xlxmert_tpu.core.config import GanConfig as JaxGanConfig
from xlxmert_tpu.parallel.mesh import make_mesh
from xlxmert_tpu.tasks import train_generator as jtg
from xlxmert_tpu_torch.cli import train_generator as cli
from xlxmert_tpu_torch.core.checkpoint import load_pytree
from xlxmert_tpu_torch.tasks import train_generator as ttg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401
from test_torch_gan_train import (  # noqa: E402
    assert_state_matches, host, jax_state, leaves,
)

pytestmark = pytest.mark.usefixtures("share_the_cores")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The CLI's RunLogger without TensorBoard (its import pulls in
    TensorFlow where that is installed, ~10 s): log.txt and
    scalars.jsonl are what these tests read."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

N_GRID, EMB, N_CLASSES, IMAGES = 4, 16, 7, 4


def write_data(tmp_path, seed=0):
    """IMAGES random 40x40 JPEGs, their cluster ids and the centroids."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    cluster_map = {}
    for i in range(IMAGES):
        name = f"im{i:02d}"
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(
            img_dir / f"{name}.jpg")
        cluster_map[name] = rng.randint(0, N_CLASSES,
                                        (N_GRID * N_GRID,)).astype(np.int64)
    np.save(tmp_path / "centroids.npy",
            (rng.randn(N_CLASSES, EMB) * 0.2).astype(np.float32))
    with open(tmp_path / "clusters.pkl", "wb") as f:
        pickle.dump(cluster_map, f)
    return ["--images_dir", str(img_dir),
            "--centroids", str(tmp_path / "centroids.npy"),
            "--cluster_pkl", str(tmp_path / "clusters.pkl"),
            "--output", str(tmp_path / "snap_g"),
            "--batch_size", str(IMAGES), "--g_base_dim", "8",
            "--d_base_dim", "8", "--codebook_dim", "8",
            "--emb_dim", str(EMB), "--n_grid", str(N_GRID),
            "--resize_target_size", "16", "--fp32", "--device", "cpu"]


def test_cli_trains_on_jpegs_end_to_end(tmp_path):
    """Two epochs: G_{epoch}.msgpack in the JAX layout, which
    cli/sample_images reads and renders; FULL checkpoints that resume;
    the logs; PIL only inside image_code_batches."""
    from xlxmert_tpu_torch.cli import sample_images

    base = write_data(tmp_path)
    out = cli.main(base + ["--epochs", "2", "--log_step", "2",
                           "--save_full_state"])
    snap = tmp_path / "snap_g"
    assert out["pairs"] == 2 and out["step"] == 4
    assert all(np.isfinite(v) for v in out["last"].values())
    for e in (0, 1):
        assert (snap / f"G_{e}.msgpack").exists()
        assert (snap / f"G_{e}_FULL.msgpack").exists()
    scalars = (snap / "scalars.jsonl").read_text()
    assert "g_total" in scalars and "d_cls_loss" in scalars
    tree = load_pytree(str(snap / "G_1.msgpack"))
    assert set(tree) == {"params", "sn"}
    ns = sample_images.parse_args([
        "--load", "x", "--grid_size", str(N_GRID), "--target_size", "16",
        "--g_base_dim", "8", "--codebook_dim", "8", "--device", "cpu"])
    centroids = np.load(tmp_path / "centroids.npy")
    gen = sample_images.build_renderer(ns, {
        "generator": sample_images.split_generator_ckpt(tree),
        "centroids": centroids}, "cpu")
    saved = load_pytree(str(snap / "G_1_FULL.msgpack"))
    assert int(saved.pop("epoch")) == 1
    full = ttg.restore_state(
        ttg.GanEngine(cli.gan_config(cli.parse_args(base), N_CLASSES),
                      device="cpu").create_state(1, centroids), saved)
    from xlxmert_tpu_torch.models.gan import render, variables_of

    img = render(gen, torch.from_numpy(
        centroids[np.arange(N_GRID * N_GRID) % N_CLASSES][None]))
    assert img.shape == (1, 16, 16, 3) and img.min() >= 0 and img.max() <= 1
    # the FULL checkpoint's generator is G_1.msgpack's
    want = dict(leaves(variables_of(full.G)["params"]))
    for p, x in leaves(tree["params"]):
        assert np.array_equal(x, want[p]), p
    assert full.step == 2 and full.opt_d.count == 2
    # --resume starts at the epoch after the one stored in the tree
    again = cli.main(base + ["--epochs", "3", "--resume",
                             str(snap / "G_1_FULL.msgpack")])
    assert again["pairs"] == 1 and (snap / "G_2.msgpack").exists()
    assert "exact-resumed GAN state" in (snap / "log.txt").read_text()
    top = [n for n in ast.parse(open(cli.__file__).read()).body
           if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("PIL" in ast.dump(n) for n in top)


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """The CLI's config and data, the JAX engine's state after one pair
    (noise scales then set to 0), its FULL file as the JAX CLI writes it
    (epoch 0), and the JAX engine's next pair on the batch the port CLI
    will read in epoch 1."""
    tmp = tmp_path_factory.mktemp("resume")
    base = write_data(tmp, seed=1)
    ns = cli.parse_args(base)
    cfg = cli.gan_config(ns, N_CLASSES)
    jeng = jtg.GanEngine(JaxGanConfig(**dataclasses.asdict(cfg)),
                         mesh=make_mesh(devices=jax.devices()[:1]))
    centroids = np.load(tmp / "centroids.npy")
    c = jnp.asarray(centroids)
    start = ttg.GanEngine(cfg, device="cpu").create_state(5, centroids)
    jstate = jax_state(jeng, ttg.state_to_tree(start))
    paths = sorted((tmp / "imgs").iterdir())
    from xlxmert_tpu_torch.data.io import ClusterMap

    cmap = ClusterMap(str(tmp / "clusters.pkl"))

    def batch(epoch):
        return next(cli.image_code_batches(paths, cmap, centroids, cfg,
                                           IMAGES, shuffle_seed=cfg.seed
                                           + epoch))

    key = jax.random.PRNGKey(0)
    jstate, _ = jeng.d_step()(jstate, batch(0), c, key)
    jstate, _ = jeng.g_step()(jstate, batch(0), c, key)
    jstate = jstate.replace(params_g=jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.zeros_like(x) if "noise" in jax.tree_util.keystr(p)
        else x, jstate.params_g))
    full = host(serialization.to_state_dict(jstate))
    full["epoch"] = np.asarray(0, np.int32)
    path = str(tmp / "snap_g" / "G_0_FULL.msgpack")
    jax_save_pytree(full, path)
    jstate, _ = jeng.d_step()(jstate, batch(1), c, key)
    jstate, _ = jeng.g_step()(jstate, batch(1), c, key)
    return dict(base=base, cfg=cfg, path=path, jstate=jstate, tmp=tmp)


def test_resume_of_a_jax_full_checkpoint_continues_as_the_jax_engine(
        jax_pair):
    """The port CLI resumes the JAX-written FULL (epoch 0, step 1) and
    trains epoch 1, one pair on the same batch as the JAX engine: the
    state it writes equals the JAX engine's after that pair."""
    out = cli.main(jax_pair["base"] + ["--epochs", "2", "--resume",
                                       jax_pair["path"],
                                       "--save_full_state"])
    assert out["pairs"] == 1 and out["step"] == 1 + 2
    written = load_pytree(str(jax_pair["tmp"] / "snap_g"
                              / "G_1_FULL.msgpack"))
    assert int(written.pop("epoch")) == 1
    cfg = jax_pair["cfg"]
    assert_state_matches(jax_pair["jstate"], out["state"], cfg.g_lr,
                         cfg.d_lr)
    now = dict(leaves(ttg.state_to_tree(out["state"])))
    assert {p for p, _ in leaves(written)} == set(now)
    for p, x in leaves(written):
        assert np.array_equal(x, now[p]), p


def test_a_port_full_checkpoint_restores_in_jax(jax_pair, tmp_path):
    """A FULL tree the port wrote (port save_pytree) restores in the JAX
    package (its load_pytree and restore_state onto the JAX engine's
    state) with every leaf equal."""
    from xlxmert_tpu.core.checkpoint import load_pytree as jax_load_pytree
    from xlxmert_tpu_torch.core.checkpoint import save_pytree

    centroids = np.load(jax_pair["tmp"] / "centroids.npy")
    state = ttg.GanEngine(jax_pair["cfg"], device="cpu").create_state(
        9, centroids)
    tree = dict(ttg.state_to_tree(state), epoch=np.asarray(3, np.int32))
    save_pytree(tree, str(tmp_path / "G_3_FULL.msgpack"))
    loaded = jax_load_pytree(str(tmp_path / "G_3_FULL.msgpack"))
    assert int(loaded.pop("epoch")) == 3
    restored, _ = jax_restore_state(jax_pair["jstate"], loaded)
    got = host(serialization.to_state_dict(restored))
    want = ttg.state_to_tree(state)
    assert {p for p, _ in leaves(got)} == {p for p, _ in leaves(want)}
    ref = dict(leaves(want))
    for p, x in leaves(got):
        assert np.array_equal(x, ref[p]), p


def test_gan_phase_runs_end_to_end_on_the_cpu():
    """chip_smoke's phase (k) at a tiny size with the card's work on the
    CPU: the CLI's loop (every loss finite, no port kernel launched),
    G_0.msgpack rendered, chained_gd_step timed, the steps' times and the
    fp32 card-vs-CPU check (CPU against CPU here: equal)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from xlxmert_tpu_torch.ops import attention, int8_matmul

    sizes = dict(batch=2, target=16, grid=4, emb=16, classes=7, g_base=8,
                 d_base=8, codebook=8, pairs=2, chain=2, check=2)
    lines = []
    kernels = [attention.KERNEL, int8_matmul.KERNEL]
    out = chip_smoke.run_gan_path(torch, chip_smoke.parse_args(["--seed",
                                                                "3"]),
                                  kernels, lines.append, device="cpu",
                                  sizes=sizes)
    assert len(out["losses"]) == 2 and out["g0_renders"]
    assert out["launches"] == {"mha_blhd": 0, "int8_dense": 0}
    assert out["pairs_per_s"] > 0 and out["images_per_s"] == pytest.approx(
        2 * out["pairs_per_s"])
    assert set(out["step_ms"]) == {"d_step", "g_step"}
    assert out["conv_flop_per_pair"] > 0
    check = out["card_vs_cpu"]
    assert max(check["loss_rel_diff"].values()) == 0.0
    assert min(check["grad_cosine"].values()) > 0.9999999
    assert max(check["sn_rel_diff"].values()) == 0.0
    assert "profile" not in out
    assert any("images/s" in line for line in lines)
