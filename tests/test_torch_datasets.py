"""The port's data tier against the JAX package: normalizers (streaming and
one-shot fits, JSON serde, the checkpoint zip's ``normalizer.json`` in
both directions), every fetcher on tiny files written to ``tmp_path``
(IDX gzipped and raw, CIFAR binary batches, SVHN ``.mat``, image trees,
UCI series), the iterators' batch order, CSV records, image directories,
``ensure_extracted``, the benchmark iterator and the prefetch callbacks,
and the ``eval`` verb on a labelled CSV.

The data tier is numpy on the host in both packages: arrays compare
exactly, except the fitted statistics (float32 results of float64
sums in another order: rtol 1e-6) and the network outputs the ``eval``
verb prints (the same floats: the printed statistics are equal).
"""

import gzip
import io
import os
import struct
import subprocess
import sys
import tarfile
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import cacheable as jcache
from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import iterator as jit_
from deeplearning4j_tpu.datasets import normalizers as jn
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import datasets as tds
from deeplearning4j_tpu_torch.datasets import cacheable as tcache
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import images as timg
from deeplearning4j_tpu_torch.datasets import iterator as tit
from deeplearning4j_tpu_torch.datasets import normalizers as tn
from deeplearning4j_tpu_torch.datasets import records as trec
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------

def _batches(rs, shape, n_batches, offset=0.0):
    return [(rs.randn(*shape).astype(np.float32) * 3 + offset, None) for _ in range(n_batches)]


@pytest.mark.parametrize("shape", [(7, 5), (4, 3, 3, 2), (3, 6, 4)])
def test_standardize_streaming_fit_matches_jax(shape):
    rs = np.random.RandomState(0)
    batches = _batches(rs, shape, 5, offset=1.7e4)
    j = jn.NormalizerStandardize().fit_iterator(batches)
    t = tn.NormalizerStandardize().fit_iterator(batches)
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)
    x = batches[0][0]
    np.testing.assert_array_equal(t.transform(x), j.transform(x))
    np.testing.assert_array_equal(t.revert(t.transform(x)), j.revert(j.transform(x)))
    # the streaming fit equals a one-shot float64 fit of the whole array
    full = np.concatenate([b for b, _ in batches]).astype(np.float64)
    flat = full.reshape(-1, shape[-1])
    np.testing.assert_allclose(t.mean, flat.mean(0), rtol=1e-6)
    np.testing.assert_allclose(t.std, flat.std(0), rtol=1e-6)


def test_standardize_floors_constant_columns_and_survives_large_offsets():
    x = np.zeros((6, 3), np.float64)
    x[:, 0] = 5.0                               # constant: std floor 1.0
    x[:, 1] = 1.7e9 + np.arange(6)              # timestamp-like offset
    x[:, 2] = np.arange(6)
    batches = [(x[:2], None), (x[2:5], None), (x[5:], None)]
    t = tn.NormalizerStandardize().fit_iterator(batches)
    j = jn.NormalizerStandardize().fit_iterator(batches)
    assert t.std[0] == 1.0
    np.testing.assert_array_equal(t.std, j.std)
    np.testing.assert_allclose(t.std[1], np.arange(6).std(), rtol=1e-6)  # not cancelled to 0


def test_minmax_and_image_scalers_match_jax():
    rs = np.random.RandomState(1)
    batches = _batches(rs, (5, 4), 3)
    j = jn.NormalizerMinMaxScaler(-1.0, 2.0).fit_iterator(batches)
    t = tn.NormalizerMinMaxScaler(-1.0, 2.0).fit_iterator(batches)
    x = batches[1][0]
    np.testing.assert_array_equal(t.transform(x), j.transform(x))
    np.testing.assert_array_equal(t.revert(t.transform(x)), j.revert(j.transform(x)))
    pix = rs.randint(0, 256, (2, 4, 4, 1)).astype(np.float32)
    ji, ti = jn.ImagePreProcessingScaler(), tn.ImagePreProcessingScaler()
    np.testing.assert_array_equal(ti.transform(pix), ji.transform(pix))
    assert ti.transform(pix).min() >= 0.0 and ti.transform(pix).max() <= 1.0


def test_normalizer_json_round_trips_between_packages():
    rs = np.random.RandomState(2)
    batches = _batches(rs, (6, 3), 2)
    x = batches[0][0]
    for jcls, tcls, args in ((jn.NormalizerStandardize, tn.NormalizerStandardize, ()),
                             (jn.NormalizerMinMaxScaler, tn.NormalizerMinMaxScaler, (0.0, 1.0)),
                             (jn.ImagePreProcessingScaler, tn.ImagePreProcessingScaler, ())):
        j = jcls(*args).fit_iterator(batches)
        t = tcls(*args).fit_iterator(batches)
        assert t.to_json() == j.to_json()
        from_j = tn._FittedNormalizer.from_json(j.to_json())
        from_t = jn._FittedNormalizer.from_json(t.to_json())
        assert type(from_j) is tcls and type(from_t) is jcls
        np.testing.assert_array_equal(from_j.transform(x), j.transform(x))
        np.testing.assert_array_equal(from_t.transform(x), t.transform(x))


def _tiny_zip_pair(tmp_path):
    from deeplearning4j_tpu.nn import layers as JL
    from deeplearning4j_tpu.nn.conf import inputs as JI
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    net = JNet(JConf(seed=3).list(JL.DenseLayer(n_out=4, activation="tanh"),
                                  JL.OutputLayer(n_out=2), input_type=JI.FeedForwardType(3)))
    net.init()
    path = tmp_path / "m.zip"
    jser.save_model(net, str(path))
    return net, path


def test_normalizer_zip_round_trip_both_ways(tmp_path):
    jnet, path = _tiny_zip_pair(tmp_path)
    rs = np.random.RandomState(4)
    batches = _batches(rs, (8, 3), 2)
    norm = tn.NormalizerStandardize().fit_iterator(batches)
    tser.add_normalizer_to_model(str(path), norm)
    with pytest.raises(ValueError, match="already contains"):
        tser.add_normalizer_to_model(str(path), norm)
    # the port's entry restores in the JAX package, and the zip still loads in both
    got = jser.restore_normalizer(str(path))
    np.testing.assert_array_equal(got.mean, norm.mean)
    np.testing.assert_array_equal(got.std, norm.std)
    net = tser.load_model(str(path), device="cpu")
    x = rs.randn(2, 3).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)), atol=1e-6)
    # and the JAX package's entry restores in the port
    other = tmp_path / "b"
    other.mkdir()
    _, path2 = _tiny_zip_pair(other)
    jnorm = jn.NormalizerMinMaxScaler().fit_iterator(batches)
    jser.add_normalizer_to_model(str(path2), jnorm)
    tnorm = tser.restore_normalizer(str(path2))
    assert isinstance(tnorm, tn.NormalizerMinMaxScaler)
    np.testing.assert_array_equal(tnorm.transform(x), jnorm.transform(x))


def test_restore_normalizer_absent_and_jvm_entry(tmp_path):
    _, path = _tiny_zip_pair(tmp_path)
    assert tser.restore_normalizer(str(path)) is None
    with zipfile.ZipFile(path, "a") as z:
        z.writestr("normalizer.bin", b"\xac\xed\x00\x05")
    with pytest.raises(ValueError, match="normalizer.bin"):
        tser.restore_normalizer(str(path))


# ---------------------------------------------------------------------------
# fetchers
# ---------------------------------------------------------------------------

def write_idx(path, arr, gz=False):
    """An IDX file (big-endian header: 0, dtype code, ndim, dims)."""
    code = {np.uint8: 0x08, np.int8: 0x09, np.int16: 0x0B, np.int32: 0x0C,
            np.float32: 0x0D, np.float64: 0x0E}[arr.dtype.type]
    data = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data += arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if gz else open)(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(data)


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    return tmp_path


def _mnist_files(root, n_train=10, n_test=6, seed=0):
    rs = np.random.RandomState(seed)
    d = root / "mnist"
    d.mkdir(parents=True, exist_ok=True)
    write_idx(d / "train-images-idx3-ubyte", rs.randint(0, 256, (n_train, 28, 28)).astype(np.uint8),
              gz=True)
    write_idx(d / "train-labels-idx1-ubyte", rs.randint(0, 10, n_train).astype(np.uint8), gz=True)
    write_idx(d / "t10k-images-idx3-ubyte", rs.randint(0, 256, (n_test, 28, 28)).astype(np.uint8))
    write_idx(d / "t10k-labels-idx1-ubyte", rs.randint(0, 10, n_test).astype(np.uint8))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32, np.float64])
def test_read_idx_matches_jax(tmp_path, dtype):
    arr = (np.random.RandomState(0).rand(3, 4, 2) * 100).astype(dtype)
    for gz in (False, True):
        write_idx(tmp_path / f"a{gz}", arr, gz=gz)
        p = str(tmp_path / f"a{gz}") + (".gz" if gz else "")
        np.testing.assert_array_equal(tf._read_idx(p), jf._read_idx(p))
        np.testing.assert_array_equal(tf._read_idx(p), arr)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("flatten", [False, True])
def test_mnist_fetcher_matches_jax(data_root, train, flatten):
    _mnist_files(data_root)
    tx, ty = tf.MnistDataFetcher(train=train).arrays(flatten=flatten)
    jx, jy = jf.MnistDataFetcher(train=train).arrays(flatten=flatten)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tx.shape[1:] == ((784,) if flatten else (28, 28, 1))


def test_mnist_iterator_yields_jax_batches(data_root):
    _mnist_files(data_root, n_train=23)
    t_it = tf.mnist_iterator(batch_size=5, shuffle=True, seed=123)
    j_it = jf.mnist_iterator(batch_size=5, shuffle=True, seed=123)
    for _epoch in range(2):
        tb, jb = list(t_it), list(j_it)
        assert [b.features.shape[0] for b in tb] == [5, 5, 5, 5, 3]
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)


def test_missing_mnist_names_the_layout(data_root):
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        tf.MnistDataFetcher()


@pytest.mark.parametrize("split", ["letters", "digits", "balanced"])
def test_emnist_fetcher_matches_jax(data_root, split):
    tag, n_cls = tf.EMNIST_SPLITS[split]
    d = data_root / "emnist"
    d.mkdir()
    rs = np.random.RandomState(1)
    lo = 1 if split == "letters" else 0
    write_idx(d / f"emnist-{tag}-train-images-idx3-ubyte",
              rs.randint(0, 256, (7, 28, 28)).astype(np.uint8))
    write_idx(d / f"emnist-{tag}-train-labels-idx1-ubyte",
              rs.randint(lo, n_cls + lo, 7).astype(np.uint8), gz=True)
    tx, ty = tf.EmnistDataFetcher(split=split).arrays(flatten=True)
    jx, jy = jf.EmnistDataFetcher(split=split).arrays(flatten=True)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError, match="Unknown EMNIST split"):
        tf.EmnistDataFetcher(split="nope")


def test_cifar10_fetcher_matches_jax(data_root):
    d = data_root / "cifar10" / "cifar-10-batches-bin"
    d.mkdir(parents=True)
    rs = np.random.RandomState(2)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (3, 1)), rs.randint(0, 256, (3, 3072))], 1)
        (d / name).write_bytes(rec.astype(np.uint8).tobytes())
    for train in (True, False):
        tx, ty = tf.Cifar10DataFetcher(train=train, limit=11).arrays()
        jx, jy = jf.Cifar10DataFetcher(train=train, limit=11).arrays()
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    a = list(tf.cifar10_iterator(batch_size=4, limit=9))
    b = list(jf.cifar10_iterator(batch_size=4, limit=9))
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.features, q.features)


def test_svhn_fetcher_matches_jax(data_root):
    import scipy.io

    d = data_root / "svhn"
    d.mkdir()
    rs = np.random.RandomState(3)
    scipy.io.savemat(str(d / "train_32x32.mat"),
                     {"X": rs.randint(0, 256, (32, 32, 3, 5)).astype(np.uint8),
                      "y": np.array([[10], [1], [2], [10], [9]], np.uint8)})
    tx, ty = tf.SvhnDataFetcher(train=True).arrays()
    jx, jy = jf.SvhnDataFetcher(train=True).arrays()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert ty[0, 0] == 1.0  # label 10 is digit 0


def _png(path, rs, size=(6, 5)):
    from PIL import Image

    Image.fromarray(rs.randint(0, 256, (size[1], size[0], 3)).astype(np.uint8)).save(path)


def test_tiny_imagenet_and_lfw_match_jax(data_root):
    pytest.importorskip("PIL")
    rs = np.random.RandomState(4)
    root = data_root / "tiny-imagenet-200"
    wnids = ["n01", "n02"]
    (root / "val" / "images").mkdir(parents=True)
    (root / "wnids.txt").write_text("\n".join(wnids) + "\n")
    ann = []
    for i, w in enumerate(wnids):
        d = root / "train" / w / "images"
        d.mkdir(parents=True)
        for k in range(2):
            _png(d / f"{w}_{k}.JPEG", rs, (64, 64))
        _png(root / "val" / "images" / f"val_{i}.JPEG", rs, (64, 64))
        ann.append(f"val_{i}.JPEG\t{w}\t0\t0\t1\t1")
    (root / "val" / "val_annotations.txt").write_text("\n".join(ann) + "\n")
    for train in (True, False):
        tx, ty = tf.TinyImageNetFetcher(train=train).arrays()
        jx, jy = jf.TinyImageNetFetcher(train=train).arrays()
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for person, n in (("alice", 2), ("bob", 1)):
        d = data_root / "lfw" / person
        d.mkdir(parents=True)
        for k in range(n):
            _png(d / f"{person}_{k}.jpg", rs)
    t = tf.LfwDataFetcher(image_size=8, min_images_per_person=2)
    j = jf.LfwDataFetcher(image_size=8, min_images_per_person=2)
    assert t.people == j.people == ["alice"]
    np.testing.assert_array_equal(t.arrays()[0], j.arrays()[0])
    np.testing.assert_array_equal(t.arrays()[1], j.arrays()[1])


def test_uci_iris_and_synthetic_match_jax(data_root):
    rs = np.random.RandomState(5)
    (data_root / "uci").mkdir()
    np.savetxt(data_root / "uci" / "synthetic_control.data", rs.rand(600, 60) * 30, fmt="%.4f")
    for train in (True, False):
        tx, ty = tf.UciSequenceDataFetcher(train=train).arrays()
        jx, jy = jf.UciSequenceDataFetcher(train=train).arrays()
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tf.IrisDataFetcher().features, jf.IrisDataFetcher().features)
    s = tf.SyntheticDataFetcher(9, (2, 3), 4, seed=1)
    js = jf.SyntheticDataFetcher(9, (2, 3), 4, seed=1)
    np.testing.assert_array_equal(s.features, js.features)
    np.testing.assert_array_equal(s.labels, js.labels)
    for tfn, jfn in ((tf.iris_iterator, jf.iris_iterator),
                     (tf.synthetic_iterator, jf.synthetic_iterator),
                     (tf.uci_sequence_iterator, jf.uci_sequence_iterator)):
        for a, b in zip(tfn(), jfn()):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)


def test_the_package_exports_what_jax_exports():
    import deeplearning4j_tpu.datasets as jds

    names = {n for n in dir(jds) if not n.startswith("_")} - {
        "ShardedDataSetIterator", "cacheable", "fetchers", "iterator"}
    missing = {n for n in names if not hasattr(tds, n)}
    assert not missing


# ---------------------------------------------------------------------------
# records, images, cacheable
# ---------------------------------------------------------------------------

def test_csv_dataset_matches_jax(tmp_path):
    rs = np.random.RandomState(6)
    arr = np.concatenate([rs.rand(9, 4), rs.randint(0, 3, (9, 1))], 1)
    p = tmp_path / "d.csv"
    p.write_text("a,b,c,d,label\n" + "\n".join(",".join(f"{v:.6f}" for v in r) for r in arr) + "\n")
    for kw in ({"label_column": -1, "n_classes": 3, "skip_lines": 1},
               {"label_column": 0, "skip_lines": 1}, {"label_column": None, "skip_lines": 1}):
        tx, ty = trec.csv_dataset(str(p), **kw)
        jx, jy = jrec.csv_dataset(str(p), **kw)
        np.testing.assert_array_equal(tx, jx)
        if jy is None:
            assert ty is None
        else:
            np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError, match="outside"):
        trec.csv_dataset(str(p), n_classes=2, skip_lines=1)
    with pytest.raises(ValueError, match="no data rows"):
        trec.read_csv_records(str(p), skip_lines=100)


@pytest.mark.parametrize("align", ["equal", "end"])
def test_sequence_dataset_matches_jax(tmp_path, align):
    rs = np.random.RandomState(7)
    feats, labs = [], []
    for i, t in enumerate((3, 5, 4)):
        f = tmp_path / f"f{i}.csv"
        lab = tmp_path / f"l{i}.csv"
        f.write_text("\n".join(",".join(f"{v:.5f}" for v in r) for r in rs.rand(t, 2)))
        n_lab = t if align == "equal" else 1
        lab.write_text("\n".join(str(v) for v in rs.randint(0, 3, n_lab)))
        feats.append(str(f))
        labs.append(str(lab))
    got = trec.sequence_dataset(feats, labs, n_classes=3, align=align)
    want = jrec.sequence_dataset(feats, labs, n_classes=3, align=align)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    reader = trec.CSVSequenceRecordReader()
    assert len(reader.read_all(str(tmp_path / "f*.csv"))) == 3
    with pytest.raises(ValueError, match="n_classes is required"):
        trec.sequence_dataset(feats, labs)


def test_image_dataset_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    from deeplearning4j_tpu.datasets import images as jimg

    rs = np.random.RandomState(8)
    for c in ("cats", "dogs"):
        (tmp_path / c).mkdir()
        for k in range(2):
            _png(tmp_path / c / f"{k}.PNG", rs)
    for ch in (1, 3):
        tx, ty, tcls = timg.image_dataset(str(tmp_path), height=4, width=3, channels=ch)
        jx, jy, jcls = jimg.image_dataset(str(tmp_path), height=4, width=3, channels=ch)
        assert tcls == jcls == ["cats", "dogs"]
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError, match="BOTH"):
        timg.load_image(str(tmp_path / "cats" / "0.PNG"), height=3)


@pytest.mark.parametrize("kind", ["zip", "tgz"])
def test_ensure_extracted_unpacks_a_local_archive(tmp_path, kind):
    payload = {"ds/a.txt": b"alpha", "ds/sub/b.txt": b"beta"}
    arch = tmp_path / ("ds.zip" if kind == "zip" else "ds.tar.gz")
    if kind == "zip":
        with zipfile.ZipFile(arch, "w") as z:
            for k, v in payload.items():
                z.writestr(k, v)
    else:
        with tarfile.open(arch, "w:gz") as t:
            for k, v in payload.items():
                info = tarfile.TarInfo(k)
                info.size = len(v)
                t.addfile(info, io.BytesIO(v))
    got = tcache.ensure_extracted("out", arch.name, root=str(tmp_path))
    assert (Path(got) / "ds" / "sub" / "b.txt").read_bytes() == b"beta"
    # the JAX package finds the same directory already there
    assert jcache.ensure_extracted("out", arch.name, root=str(tmp_path)) == got
    arch.unlink()  # extracted once: the archive is not needed again
    assert tcache.ensure_extracted("out", arch.name, root=str(tmp_path)) == got
    with pytest.raises(FileNotFoundError, match="does not download"):
        tcache.ensure_extracted("other", "missing.zip", root=str(tmp_path))


# ---------------------------------------------------------------------------
# iterators and callbacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labels_shape", [None, (4, 2)])
def test_benchmark_iterator_matches_jax(labels_shape):
    t = tit.BenchmarkDataSetIterator((4, 3), 5, 3, seed=2, labels_shape=labels_shape)
    j = jit_.BenchmarkDataSetIterator((4, 3), 5, 3, seed=2, labels_shape=labels_shape)
    tb, jb = list(t), list(j)
    assert len(tb) == len(jb) == 3 and t.batch_size == 4
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert len(list(t)) == 3  # reset by iteration


def test_interleaved_callback_round_robins_and_realigns():
    src = tit.ArrayDataSetIterator(np.arange(20, dtype=np.float32).reshape(10, 2),
                                   np.ones((10, 1), np.float32), 2)
    cb = tit.InterleavedDataSetCallback(devices=["cpu", "cpu"])
    it = tit.AsyncDataSetIterator(src, queue_size=2, callback=cb)
    for _epoch in range(2):
        out = list(it)
        assert len(out) == 5 and all(torch.is_tensor(b.features) for b in out)
        np.testing.assert_array_equal(torch.cat([b.features for b in out]).numpy(),
                                      np.arange(20).reshape(10, 2))
        assert cb._counter == 5  # reset() realigned the round-robin each epoch
    it.close()
    with pytest.raises(ValueError, match="mutually exclusive"):
        tit.AsyncDataSetIterator(src, device="cpu", callback=cb)


def test_base_callback_passes_batches_through():
    ds = tit.DataSet(np.ones((2, 2)), np.zeros((2, 1)))
    assert tit.DataSetCallback().call(ds) is ds


def test_interleaved_callback_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tit.InterleavedDataSetCallback()


# ---------------------------------------------------------------------------
# the eval verb on a labelled CSV
# ---------------------------------------------------------------------------

def test_eval_cli_on_a_labelled_csv_matches_jax(tmp_path):
    jnet, path = _tiny_zip_pair(tmp_path)
    rs = np.random.RandomState(9)
    x = rs.randn(12, 3).astype(np.float32)
    y = rs.randint(0, 2, 12)
    csv = tmp_path / "test.csv"
    csv.write_text("f0,f1,f2,y\n" + "\n".join(
        ",".join(repr(float(v)) for v in row) + f",{lab}" for row, lab in zip(x, y)) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "eval", "--model-path", str(path),
         "--data", str(csv), "--label-column", "3", "--n-classes", "2", "--skip-lines", "1",
         "--device", "cpu", "--batch-size", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    from deeplearning4j_tpu.eval.classification import Evaluation

    ref = Evaluation()
    ref.eval(np.eye(2)[y], np.asarray(jnet.output(x)))
    assert ref.stats() in proc.stdout
    np.save(tmp_path / "y.npy", y)
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "eval", "--model-path", str(path),
         "--data", str(csv), "--labels", str(tmp_path / "y.npy"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--labels cannot be combined" in proc.stderr


def test_eval_cli_reshapes_flat_csv_rows_for_an_image_model(tmp_path):
    """A CSV row holds an image as H*W*C values: the port reshapes it to the
    model's input image (DL4J's InputType.convolutionalFlat); the JAX CLI
    feeds the flat rows, which a conv model cannot take."""
    from deeplearning4j_tpu.nn import layers as JL
    from deeplearning4j_tpu.nn.conf import inputs as JI
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    net = JNet(JConf(seed=5).list(JL.ConvolutionLayer(n_out=2, kernel=(3, 3), activation="relu"),
                                  JL.OutputLayer(n_out=3),
                                  input_type=JI.ConvolutionalType(6, 6, 1)))
    net.init()
    path = tmp_path / "cnn.zip"
    jser.save_model(net, str(path))
    rs = np.random.RandomState(10)
    x = rs.rand(7, 6, 6, 1).astype(np.float32)
    y = rs.randint(0, 3, 7)
    csv = tmp_path / "img.csv"
    csv.write_text("\n".join(",".join(repr(float(v)) for v in row) + f",{lab}"
                             for row, lab in zip(x.reshape(7, 36), y)) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "eval", "--model-path", str(path),
         "--data", str(csv), "--label-column", "36", "--n-classes", "3", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from deeplearning4j_tpu.eval.classification import Evaluation

    ref = Evaluation()
    ref.eval(np.eye(3)[y], np.asarray(net.output(x)))
    assert ref.stats() in proc.stdout
