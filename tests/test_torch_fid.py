"""The port's FID (`xlxmert_tpu_torch.utils.fid`, `cli/eval_fid`) against
the JAX package's on the CPU: the Fréchet math in float64 (the same
numpy operations: equal to the last bit), the host resize and the
checksum check, and `eval_fid.main` end to end on small PNG directories
with both extractors and --weights as .pth and as .msgpack, whose FID
must equal the JAX CLI's on the same files and weights to a relative
1e-4 (the features agree to ~1e-6 of their scale in fp32)."""
import hashlib
import os

import numpy as np
import pytest
import torch

from xlxmert_tpu.cli import eval_fid as jcli
from xlxmert_tpu.utils import fid as jfid
from xlxmert_tpu_torch.cli import eval_fid as tcli
from xlxmert_tpu_torch.utils import fid as tfid

FID_REL = 1e-4


@pytest.fixture
def share_the_cores_and_blas():
    """Each pytest-xdist worker's share of the cores for torch and for
    numpy's BLAS (the Fréchet distance's 2,048-d eigh): with a thread per
    core in every worker both libraries wait on each other's spinning
    threads."""
    n = max(1, (os.cpu_count() or 1)
            // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
    else:
        with threadpool_limits(limits=n):
            yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.usefixtures("share_the_cores_and_blas")


@pytest.mark.parametrize("n,d", [(60, 8), (6, 32)])
def test_frechet_math_equals_jax(n, d):
    """Full-rank and rank-deficient covariances (N < D)."""
    rng = np.random.RandomState(n)
    a, b = rng.randn(n, d), rng.randn(n, d) * 1.3 + 0.2
    for f in ("activation_stats",):
        for x, y in zip(getattr(tfid, f)(a), getattr(jfid, f)(a)):
            np.testing.assert_array_equal(x, y)
    m = a.T @ a
    np.testing.assert_array_equal(tfid._sqrtm_psd(m), jfid._sqrtm_psd(m))
    stats = (*jfid.activation_stats(a), *jfid.activation_stats(b))
    assert tfid.frechet_distance(*stats) == jfid.frechet_distance(*stats)
    assert tfid.fid_from_features(a, b) == jfid.fid_from_features(a, b)
    assert tfid.fid_from_features(a, a) < 1e-6 < tfid.fid_from_features(a, b)


def test_compute_fid_streams_batches_as_jax():
    rng = np.random.RandomState(2)
    real = [rng.rand(3, 4, 4, 3).astype(np.float32) for _ in range(3)]
    fake = [rng.rand(2, 4, 4, 3).astype(np.float32) for _ in range(4)]

    def fn(x):
        return x.reshape(len(x), -1)[:, :5]

    assert tfid.compute_fid(real, fake, fn) == jfid.compute_fid(
        real, fake, fn)


@pytest.mark.parametrize("shape", [(480, 640, 3), (123, 457, 3),
                                   (301, 299, 3)])
def test_bilinear_resize_np_equals_the_jax_clis_and_torch(shape):
    """Bit-equal to the JAX CLI's (the same numpy operations); F.interpolate
    agrees to < 1e-4 (it takes the source coordinates in fp32)."""
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = tcli.bilinear_resize_np(img)
    assert got.dtype == np.float32 and got.shape == (299, 299, 3)
    np.testing.assert_array_equal(got, jcli.bilinear_resize_np(img))
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(2, 0, 1)[None], size=(299, 299),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_hub_checksum_verifier_as_jax(tmp_path):
    blob = b"not really inception weights"
    prefix = hashlib.sha256(blob).hexdigest()[:8]
    good = tmp_path / f"pt_inception-2015-12-05-{prefix}.pth"
    good.write_bytes(blob)
    bad = tmp_path / "pt_inception-2015-12-05-6726825d.pth"
    bad.write_bytes(blob)
    plain = tmp_path / "resnet50.pth"
    plain.write_bytes(blob)
    for verify in (tcli.verify_hub_checksum, jcli.verify_hub_checksum):
        verify(str(good))
        verify(str(plain))
        with pytest.raises(SystemExit, match="CHECKSUM MISMATCH"):
            verify(str(bad))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two PNG directories (four images each, native shapes differing
    within and across them) and each extractor's random weights as a
    torchvision-layout .pth (inception with AuxLogits) and as a msgpack
    of the converted tree (the JAX CLI's msgpack layout)."""
    from PIL import Image

    from xlxmert_tpu_torch.core.checkpoint import save_pytree
    from xlxmert_tpu_torch.core.convert import convert_torch_state_dict
    from xlxmert_tpu_torch.models import inception, resnet

    root = tmp_path_factory.mktemp("fid")
    rng = np.random.RandomState(0)
    for name, shift in (("real", 0), ("fake", 60)):
        d = root / name
        d.mkdir()
        for i, (h, w) in enumerate([(40, 52), (64, 64), (57, 33),
                                    (80, 48)]):
            px = np.clip(rng.randint(0, 196, (h, w, 3)) + shift, 0, 255)
            Image.fromarray(px.astype(np.uint8)).save(d / f"{i}.png")
    inc = inception.inception_from_variables(inception.random_variables(1))
    res = resnet.random_init(resnet.resnet50(), seed=2)
    weights = {}
    for kind, model in (("inception", inc), ("resnet", res)):
        sd = {k.replace(".mean", ".running_mean").replace(
            ".var", ".running_var"): v for k, v in model.state_dict().items()}
        if kind == "inception":
            sd["AuxLogits.fc.weight"] = torch.ones(1008, 768)
        torch.save(sd, root / f"{kind}.pth")
        save_pytree(convert_torch_state_dict(sd), str(root / f"{kind}.msgpack"))
        weights[kind] = root / kind
    return root, weights


@pytest.mark.parametrize("kind", ["inception", "resnet"])
def test_weights_read_alike_from_pth_and_msgpack(world, kind):
    """--weights as a torchvision-layout .pth and as the JAX layout's
    msgpack give the same variables, leaf for leaf; auto picks the
    extractor from the layout."""
    _, weights = world
    got = {ext: tcli.load_extractor(str(weights[kind]) + ext)
           for ext in (".pth", ".msgpack")}
    assert got[".pth"][0] == got[".msgpack"][0] == kind
    flat = {ext: dict(_leaves(v[1])) for ext, v in got.items()}
    assert flat[".pth"].keys() == flat[".msgpack"].keys()
    assert not any("AuxLogits" in k for k in flat[".pth"])
    for k, v in flat[".pth"].items():
        np.testing.assert_array_equal(v, flat[".msgpack"][k])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("kind,ext", [("inception", ".pth"),
                                      ("resnet", ".msgpack")])
def test_eval_fid_main_equals_the_jax_cli(world, kind, ext, capsys):
    """eval_fid.main end to end with each extractor (auto), on the same
    PNGs and weights as the JAX CLI; the port on --device cpu."""
    root, weights = world
    common = ["--real_dir", str(root / "real"), "--fake_dir",
              str(root / "fake"), "--batch_size", "3", "--image_size",
              "64", "--weights", str(weights[kind]) + ext]
    ref = jcli.main(common)
    got = tcli.main(common + ["--device", "cpu"])
    assert np.isfinite(ref) and ref > 0
    assert abs(got - ref) <= FID_REL * ref, (kind, got, ref)
    assert f"extractor: {kind}" in capsys.readouterr().out


def test_eval_fid_without_weights_warns_and_is_finite(world, capsys):
    root, _ = world
    fid = tcli.main(["--real_dir", str(root / "real"), "--fake_dir",
                     str(root / "fake"), "--image_size", "64",
                     "--max_images", "3", "--device", "cpu"])
    assert np.isfinite(fid) and fid > 0
    assert "WARNING: random-init" in capsys.readouterr().out


def test_fid_of_batches_takes_in_memory_batches(world):
    """The CLI below its file reading: 256x256 batches (the size
    cli/sample_images writes) are resized to 299 inside the inception
    feature function, whose features are those of the host-resized
    images to 1e-3 of their scale (the two resizes differ by < 1e-4)."""
    _, weights = world
    kind, variables = tcli.load_extractor(str(weights["inception"])
                                          + ".pth")
    rng = np.random.RandomState(4)
    real = rng.rand(3, 256, 256, 3).astype(np.float32)
    fake = np.clip(real + 0.2, 0, 1)
    fn = tcli.feature_fn(kind, variables, "cpu")
    on_device = fn(real)
    host = fn(np.stack([tcli.bilinear_resize_np(i) for i in real]))
    assert on_device.shape == (3, 2048) and on_device.dtype == np.float32
    np.testing.assert_allclose(on_device, host, rtol=0,
                               atol=1e-3 * np.abs(host).max())
    fid = tcli.fid_of_batches([real[:2], real[2:]], [fake], kind,
                              variables, "cpu")
    assert np.isfinite(fid) and fid > 0
