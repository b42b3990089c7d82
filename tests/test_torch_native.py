"""The port's native host components against the JAX package's: the
threshold codec, FancyBlockingQueue, the ETL kernels and the HDF5 bridge
(reference analogs: libnd4j's THRESHOLD compressor, FancyBlockingQueue.java,
DataVec, Hdf5Archive.java). The port builds its own copy of the C++ sources
into its own ``_build/``; on the same inputs both packages give the same
bytes, and an HDF5 file written by either reads back in the other."""

import threading
import time

import numpy as np
import pytest

import torch_native_guard  # noqa: E402

# before any test runs: the JAX package's native library, built without the race
torch_native_guard.heal_reference_native()

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.native import codec as jcodec
from deeplearning4j_tpu.native import etl as jetl
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.native import codec, etl
from deeplearning4j_tpu_torch.native.queue import FancyBlockingQueue


def test_native_builds_into_the_ports_own_directory():
    assert native.available(), "the toolchain is present; the build must work"
    path = native.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "deeplearning4j_tpu_torch"
    assert path.exists()


class TestThresholdCodec:
    def test_sparse_roundtrip_and_residual(self):
        rs = np.random.RandomState(0)
        g = np.zeros(1000, np.float32)
        hot = rs.choice(1000, 30, replace=False)
        g[hot] = rs.choice([-1.0, 1.0], 30) * rs.uniform(0.5, 2.0, 30).astype(np.float32)
        orig = g.copy()
        msg = codec.encode(g, threshold=0.5)
        assert msg.kind == "sparse"
        target = np.zeros_like(orig)
        codec.decode(msg, target)
        np.testing.assert_allclose(target + g, orig, rtol=1e-6)
        assert set(np.unique(np.abs(target[target != 0]))) == {np.float32(0.5)}

    def test_residual_accumulates_across_rounds(self):
        g = np.full(10, 0.3, np.float32)
        msg1 = codec.encode(g, 0.5)
        assert len(msg1.payload) == 0
        g += 0.3  # residual 0.3 + new 0.3 = 0.6 > tau
        msg2 = codec.encode(g, 0.5)
        assert msg2.kind == "sparse" and len(msg2.payload) == 10
        np.testing.assert_allclose(g, 0.1, atol=1e-6)

    def test_bitmap_fallback_dense(self):
        rs = np.random.RandomState(1)
        g = rs.choice([-1.0, 1.0], 512).astype(np.float32)
        orig = g.copy()
        msg = codec.encode(g, threshold=0.5)
        assert msg.kind == "bitmap"
        target = np.zeros_like(orig)
        codec.decode(msg, target)
        np.testing.assert_allclose(target + g, orig, rtol=1e-6)
        assert msg.nbytes() == (512 + 15) // 16 * 4

    def test_numpy_vs_native_agree(self, monkeypatch):
        rs = np.random.RandomState(2)
        base = rs.randn(2000).astype(np.float32)
        g1, g2 = base.copy(), base.copy()
        m1 = codec.encode(g1, 0.8)
        t1, t2 = np.zeros_like(base), np.zeros_like(base)
        codec.decode(m1, t1)
        monkeypatch.setattr(native, "available", lambda: False)
        m2 = codec.encode(g2, 0.8)
        codec.decode(m2, t2)
        np.testing.assert_allclose(g1, g2, rtol=1e-6)
        np.testing.assert_allclose(t1, t2, rtol=1e-6)

    @pytest.mark.parametrize("density", [0.01, 0.5])
    def test_messages_equal_the_jax_packages(self, density):
        """Same residual in, same message (kind and payload) and the same
        residual left behind, sparse and bitmap."""
        rs = np.random.RandomState(3)
        base = (rs.randn(4096) * (rs.rand(4096) < density) * 3).astype(np.float32)
        mine, theirs = base.copy(), base.copy()
        m = codec.encode(mine, 1.0)
        j = jcodec.encode(theirs, 1.0)
        assert m.kind == j.kind == ("sparse" if density < 0.05 else "bitmap")
        np.testing.assert_array_equal(m.payload, j.payload)
        np.testing.assert_array_equal(mine, theirs)
        t_m, t_j = np.zeros_like(base), np.zeros_like(base)
        codec.decode(m, t_m)
        jcodec.decode(j, t_j)
        np.testing.assert_array_equal(t_m, t_j)

    def test_adaptive_threshold(self):
        at = codec.AdaptiveThreshold(initial=1e-3, min_threshold=1e-5, step=1e-4)
        at.observe(codec.EncodedUpdate("bitmap", np.zeros(4, np.uint32), 1e-3, 64))
        assert at.threshold == 2e-3
        at.observe(codec.EncodedUpdate("sparse", np.zeros(1, np.int32), 2e-3, 10000))
        assert at.threshold < 2e-3


class TestFancyBlockingQueue:
    @pytest.mark.parametrize("native_lib", [True, False])
    def test_every_consumer_sees_every_message(self, native_lib, monkeypatch):
        if not native_lib:
            def unavailable():
                raise RuntimeError("native library switched off")
            monkeypatch.setattr(native, "lib", unavailable)
        q = FancyBlockingQueue(capacity=8)
        assert q._native is native_lib
        cids = [q.register_consumer() for _ in range(3)]
        seen = {c: [] for c in cids}

        def consume(c):
            while True:
                m = q.poll(c, timeout=5.0)
                if m is None:
                    return
                seen[c].append(m)

        threads = [threading.Thread(target=consume, args=(c,)) for c in cids]
        for t in threads:
            t.start()
        msgs = [f"m{i}" for i in range(50)]
        for m in msgs:
            assert q.put(m, timeout=5.0)
        deadline = time.time() + 5
        while time.time() < deadline and any(len(seen[c]) < 50 for c in cids):
            time.sleep(0.01)
        q.close()
        for t in threads:
            t.join(timeout=5)
        for c in cids:
            assert seen[c] == msgs  # exactly once, in order

    def test_capacity_backpressure(self):
        q = FancyBlockingQueue(capacity=2)
        q.register_consumer()
        assert q.put("a", timeout=0.2)
        assert q.put("b", timeout=0.2)
        assert not q.put("c", timeout=0.2)  # full: the slow consumer blocks put

    def test_late_consumer_sees_only_new_messages(self):
        q = FancyBlockingQueue(capacity=8)
        c0 = q.register_consumer()
        q.put("old")
        assert q.poll(c0, timeout=1.0) == "old"
        c1 = q.register_consumer()
        q.put("new")
        assert q.poll(c1, timeout=1.0) == "new"
        assert q.pending(c1) == 0


class TestEtl:
    def test_u8_to_f32(self):
        img = np.random.RandomState(0).randint(0, 256, (4, 28, 28), np.uint8)
        out = etl.u8_to_f32(img)
        np.testing.assert_allclose(out, img.astype(np.float32) / 255.0, rtol=1e-6)
        np.testing.assert_array_equal(out, jetl.u8_to_f32(img))

    def test_one_hot(self):
        labels = np.array([0, 2, 1, -1, 3])  # out of range: an all-zero row
        out = etl.one_hot(labels, 3)
        np.testing.assert_array_equal(out[:3], np.eye(3, dtype=np.float32)[[0, 2, 1]])
        np.testing.assert_array_equal(out[3:], 0)
        np.testing.assert_array_equal(out, jetl.one_hot(labels, 3))

    def test_gather_rows(self):
        rs = np.random.RandomState(0)
        src = rs.randn(100, 17).astype(np.float32)
        idx = rs.permutation(100)[:32]
        np.testing.assert_array_equal(etl.gather_rows(src, idx), src[idx])
        with pytest.raises(IndexError):
            etl.gather_rows(src, np.array([100]))

    def test_nchw_to_nhwc(self):
        x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
        np.testing.assert_array_equal(etl.nchw_to_nhwc(x), x.transpose(0, 2, 3, 1))

    def test_fallbacks_agree(self, monkeypatch):
        rs = np.random.RandomState(1)
        img = rs.randint(0, 256, (3, 5), np.uint8)
        src = rs.randn(10, 4).astype(np.float32)
        idx = np.array([3, 1, 9])
        x = rs.randn(1, 2, 3, 4).astype(np.float32)
        want = (etl.u8_to_f32(img), etl.one_hot(np.array([1, 0]), 2),
                etl.gather_rows(src, idx), etl.nchw_to_nhwc(x))
        monkeypatch.setattr(native, "available", lambda: False)
        got = (etl.u8_to_f32(img), etl.one_hot(np.array([1, 0]), 2),
               etl.gather_rows(src, idx), etl.nchw_to_nhwc(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)


class TestHdf5:
    @pytest.fixture(autouse=True)
    def _needs_libhdf5(self):
        if not native.h5_available():
            pytest.skip("system libhdf5 absent")

    def _write(self, archive_cls, p, w, b):
        with archive_cls(p, "w") as f:
            f.write_dataset("model_weights/dense_1/dense_1/kernel:0", w)
            f.write_dataset("model_weights/dense_1/dense_1/bias:0", b)
            f.write_attr_string("model_config", '{"class_name": "Sequential"}')
            f.write_attr_strings("layer_names", ["dense_1"], "model_weights")
            f.write_attr_strings("weight_names", ["dense_1/kernel:0", "dense_1/bias:0"],
                                 "model_weights/dense_1")

    def _check(self, archive_cls, p, w, b):
        with archive_cls(p) as f:
            assert f.read_attr_string("model_config") == '{"class_name": "Sequential"}'
            assert f.read_attr_strings("layer_names", "model_weights") == ["dense_1"]
            assert f.read_attr_strings("weight_names", "model_weights/dense_1") == \
                ["dense_1/kernel:0", "dense_1/bias:0"]
            assert f.groups("/") == ["model_weights"]
            assert f.exists("model_weights/dense_1/dense_1/kernel:0")
            assert not f.exists("model_weights/nope")
            np.testing.assert_array_equal(f.read_dataset("model_weights/dense_1/dense_1/kernel:0"), w)
            assert f.dataset_shape("model_weights/dense_1/dense_1/bias:0") == (7,)

    @pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"), ("jax", "port")])
    def test_roundtrip(self, tmp_path, writer, reader):
        from deeplearning4j_tpu.native.h5 import Hdf5Archive as JArchive
        from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

        cls = {"port": Hdf5Archive, "jax": JArchive}
        p = str(tmp_path / "t.h5")
        rs = np.random.RandomState(0)
        w = rs.randn(5, 7).astype(np.float32)
        b = rs.randn(7).astype(np.float32)
        self._write(cls[writer], p, w, b)
        self._check(cls[reader], p, w, b)

    def test_null_padded_string_array_keeps_its_last_character(self, tmp_path):
        """A fixed-length string-array attribute pads the shorter values
        with nulls; every value, the longest included, reads back whole
        (the bridge once dropped the last character of each)."""
        from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

        p = str(tmp_path / "s.h5")
        names = ["global/shared/dense_1_W:0", "b:0", "x"]
        with Hdf5Archive(p, "w") as f:
            f.make_group("g")
            f.write_attr_strings("weight_names", names, "g")
            f.write_attr_string("one", "ends-in-0", "g")
        with Hdf5Archive(p) as f:
            assert f.read_attr_strings("weight_names", "g") == names
            assert f.read_attr_string("one", "g") == "ends-in-0"

    def test_listing_kinds(self, tmp_path):
        from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

        p = str(tmp_path / "k.h5")
        with Hdf5Archive(p, "w") as f:
            f.make_group("grp")
            f.write_dataset("ds", np.zeros(3, np.float32))
        with Hdf5Archive(p) as f:
            assert dict((name, kind) for kind, name in f.list("/")) == {"grp": "g", "ds": "d"}
            assert f.datasets("/") == ["ds"]

    def test_missing_file_and_attribute_raise(self, tmp_path):
        from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

        with pytest.raises(IOError, match="cannot open"):
            Hdf5Archive(str(tmp_path / "absent.h5"))
        p = str(tmp_path / "e.h5")
        with Hdf5Archive(p, "w") as f:
            with pytest.raises(IOError, match="does not exist"):
                f.write_attr_string("a", "v", "nope")
        with Hdf5Archive(p) as f:
            with pytest.raises(IOError, match="no string attribute"):
                f.read_attr_string("model_config")


def test_both_packages_report_the_same_availability():
    assert native.available() == jnative.available()
    assert native.h5_available() == jnative.h5_available()
