"""The port's host readers (data/io.py: GridFeatureReader's RAM cache,
keys and get_batch; BboxFeatureReader's cache and keys;
ClusterMap.get_batch) and core/config.SampleConfig against the JAX
package's, on small h5 files written with h5py. Features are compared
exactly (both read the same float32 bytes)."""
import pickle

import h5py
import numpy as np
import pytest

from xlxmert_tpu.core.config import SampleConfig as JaxSampleConfig
from xlxmert_tpu.data import io as jio
from xlxmert_tpu_torch.core.config import SampleConfig
from xlxmert_tpu_torch.data import io as tio

IDS = [f"img_{i}" for i in range(5)]


@pytest.fixture(scope="module")
def grid_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("grid") / "maskrcnn_train_grid2.h5"
    r = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        for i in IDS:
            f.create_group(i)["features"] = r.randn(2, 2, 8).astype(
                np.float32)
    return str(path)


@pytest.fixture(scope="module")
def bbox_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("bbox") / "maskrcnn_train_boxes36.h5"
    r = np.random.RandomState(1)
    with h5py.File(path, "w") as f:
        for i in IDS:
            g = f.create_group(i)
            g["features"] = r.randn(3, 8).astype(np.float32)
            g["obj_id"] = r.randint(0, 9, 3).astype(np.int32)
            g["boxes"] = (r.rand(3, 4) * 700).astype(np.float32)
            g["img_w"], g["img_h"] = 640.0, 480.0
    return str(path)


def test_grid_reader_batches_keys_and_cache_equal_the_jax_reader(grid_h5):
    ids = ["img_3", "img_0", "img_3", "img_4"]
    jr = jio.GridFeatureReader(grid_h5)
    with tio.GridFeatureReader(grid_h5) as tr:
        assert tr.keys() == jr.keys() == sorted(IDS)
        got = tr.get_batch(ids)
        np.testing.assert_array_equal(got, jr.get_batch(ids))
        assert got.shape == (4, 2, 2, 8) and got.dtype == np.float32
        # into a preallocated buffer, which is returned filled
        buf = np.full((4, 2, 2, 8), np.nan, np.float32)
        assert tr.get_batch(ids, out=buf) is buf
        np.testing.assert_array_equal(buf, got)
        # the second read of an id comes from the cache: the same array
        assert tr.get("img_3") is tr.get("img_3")
        assert set(tr._cache) == {"img_0", "img_3", "img_4"}
    # read-through (cli/serve): nothing kept, the same values
    with tio.GridFeatureReader(grid_h5, cache=None) as tr:
        a, b = tr.get("img_1"), tr.get("img_1")
        assert a is not b and tr._cache is None
        np.testing.assert_array_equal(a, jr.get("img_1"))
    jr.close()


def test_bbox_reader_keys_and_cache_equal_the_jax_reader(bbox_h5):
    jr = jio.BboxFeatureReader(bbox_h5)
    for cache in ("ram", None):
        with tio.BboxFeatureReader(bbox_h5, cache=cache) as tr:
            assert tr.keys() == jr.keys() == sorted(IDS)
            for i in IDS:
                got, want = tr.get(i), jr.get(i)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
                assert (tr.get(i) is got) == (cache == "ram")
    jr.close()


def test_cluster_map_get_batch_equals_the_jax_one(tmp_path):
    r = np.random.RandomState(2)
    table = {i: r.randint(0, 50, (2, 2)) for i in IDS}
    path = tmp_path / "ids.pkl"
    with open(path, "wb") as f:
        pickle.dump(table, f)
    ids = ["img_2", "img_2", "img_0"]
    want = jio.ClusterMap(str(path)).get_batch(ids)
    for cm in (tio.ClusterMap(str(path)), tio.ClusterMap(table)):
        got = cm.get_batch(ids)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_sample_config_round_trips_and_equals_the_jax_defaults(tmp_path):
    assert SampleConfig().__dict__ == JaxSampleConfig().__dict__
    cfg = SampleConfig(sample_mode="AR", position_strategy="TLBR",
                       batch_size=64, load="x.msgpack")
    path = str(tmp_path / "sample.yaml")
    cfg.save(path)
    assert SampleConfig.from_yaml(path) == cfg
    # either package reads the other's file
    assert JaxSampleConfig.from_yaml(path).__dict__ == cfg.__dict__
    JaxSampleConfig(seed=3).save(path)
    assert SampleConfig.from_yaml(path) == SampleConfig(seed=3)
