"""Dataset fetchers: the port's copy of ``deeplearning4j_tpu/datasets/fetchers.py``.

MNIST and EMNIST (IDX files, gzipped or raw), CIFAR-10 (binary batches),
SVHN (cropped-digit ``.mat``), Tiny ImageNet and LFW (image trees, decoded
with PIL, imported only when one of those two is built), the UCI
synthetic-control series, an embedded Iris and deterministic synthetic
data; each ``*_iterator`` wraps its arrays in an ``ArrayDataSetIterator``
with the JAX package's batch order (``np.random.RandomState(seed)``).

Files are read from the data directory (``DL4J_TPU_DATA_DIR``, default
``~/.deeplearning4j_tpu/data``, the JAX package's); nothing is
downloaded: a missing file raises ``FileNotFoundError`` naming the
expected layout.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from deeplearning4j_tpu_torch.datasets.cacheable import data_dir  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator


def _read_idx(path):
    """Parse an IDX (MNIST) file, gzipped or raw."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        _, dtype_code, ndim = magic
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


class MnistDataFetcher:
    """Reads idx files from <data_dir>/mnist/ (train-images-idx3-ubyte[.gz],
    train-labels-idx1-ubyte[.gz], t10k-*)."""

    NUM_TRAIN = 60000
    NUM_TEST = 10000

    def __init__(self, train=True, root=None):
        root = root or os.path.join(data_dir(), "mnist")
        prefix = "train" if train else "t10k"
        img = self._find(root, f"{prefix}-images-idx3-ubyte")
        lab = self._find(root, f"{prefix}-labels-idx1-ubyte")
        self.images = _read_idx(img).astype(np.float32) / 255.0
        self.labels = np.eye(10, dtype=np.float32)[_read_idx(lab).astype(np.int64)]

    @staticmethod
    def _find(root, base):
        for cand in (os.path.join(root, base), os.path.join(root, base + ".gz")):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"MNIST file {base}[.gz] not found under {root}: place the "
            f"standard MNIST idx files there (nothing is downloaded), or use "
            f"SyntheticDataFetcher for benchmarks.")

    def arrays(self, flatten=False):
        x = self.images.reshape(-1, 784) if flatten else self.images[..., None]
        return x, self.labels


# Fisher's Iris measurements (public-domain data, embedded like the
# reference embeds it via IrisUtils; 150 rows of sepal/petal cm + class).
_IRIS_BASE = np.array([
    [5.0, 3.4, 1.5, 0.2], [4.9, 3.0, 1.4, 0.2], [4.7, 3.2, 1.3, 0.2],
    [4.6, 3.1, 1.5, 0.2], [5.0, 3.6, 1.4, 0.2], [5.4, 3.9, 1.7, 0.4],
    [6.4, 3.2, 4.5, 1.5], [6.9, 3.1, 4.9, 1.5], [5.5, 2.3, 4.0, 1.3],
    [6.5, 2.8, 4.6, 1.5], [5.7, 2.8, 4.5, 1.3], [6.3, 3.3, 4.7, 1.6],
    [6.3, 3.3, 6.0, 2.5], [5.8, 2.7, 5.1, 1.9], [7.1, 3.0, 5.9, 2.1],
    [6.3, 2.9, 5.6, 1.8], [6.5, 3.0, 5.8, 2.2], [7.6, 3.0, 6.6, 2.1],
], np.float32)
_IRIS_CLS = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2])


class IrisDataFetcher:
    """Iris (reference: IrisDataFetcher.java). A representative embedded
    subset expanded with class-conditional jitter to 150 examples — used for
    smoke tests exactly as the reference uses Iris."""

    def __init__(self, n=150, seed=6):
        rs = np.random.RandomState(seed)
        reps = int(np.ceil(n / len(_IRIS_BASE)))
        x = np.tile(_IRIS_BASE, (reps, 1))[:n]
        y = np.tile(_IRIS_CLS, reps)[:n]
        x = x + 0.05 * rs.randn(*x.shape).astype(np.float32)
        self.features = x
        self.labels = np.eye(3, dtype=np.float32)[y]


class SyntheticDataFetcher:
    """Deterministic random data for benchmarks/tests (reference role:
    BenchmarkDataSetIterator)."""

    def __init__(self, n, feature_shape, n_classes, seed=0, one_hot=True):
        rs = np.random.RandomState(seed)
        self.features = rs.rand(n, *feature_shape).astype(np.float32)
        idx = rs.randint(0, n_classes, n)
        self.labels = np.eye(n_classes, dtype=np.float32)[idx] if one_hot \
            else idx.astype(np.int32)


def mnist_iterator(batch_size=128, train=True, flatten=False, shuffle=True, seed=123):
    f = MnistDataFetcher(train=train)
    x, y = f.arrays(flatten=flatten)
    return ArrayDataSetIterator(x, y, batch_size, shuffle=shuffle, seed=seed)


def iris_iterator(batch_size=150, shuffle=True, seed=123):
    f = IrisDataFetcher()
    return ArrayDataSetIterator(f.features, f.labels, batch_size, shuffle=shuffle, seed=seed)


def synthetic_iterator(n=1024, feature_shape=(28, 28, 1), n_classes=10,
                       batch_size=128, seed=0):
    f = SyntheticDataFetcher(n, feature_shape, n_classes, seed=seed)
    return ArrayDataSetIterator(f.features, f.labels, batch_size)


# ---------------------------------------------------------------------------
# EMNIST (reference: EmnistDataFetcher.java / EmnistDataSetIterator.Set)
# ---------------------------------------------------------------------------

EMNIST_SPLITS = {
    # split -> (file tag, n_classes)  (reference EmnistDataSetIterator enum:
    # COMPLETE/byclass 62, MERGE/bymerge 47, BALANCED 47, LETTERS 26,
    # DIGITS 10, MNIST 10)
    "byclass": ("byclass", 62),
    "bymerge": ("bymerge", 47),
    "balanced": ("balanced", 47),
    "letters": ("letters", 26),
    "digits": ("digits", 10),
    "mnist": ("mnist", 10),
}


class EmnistDataFetcher:
    """EMNIST idx files from <data_dir>/emnist/:
    emnist-<split>-{train,test}-{images-idx3,labels-idx1}-ubyte[.gz]."""

    def __init__(self, split="balanced", train=True, root=None):
        if split not in EMNIST_SPLITS:
            raise ValueError(f"Unknown EMNIST split {split!r}; "
                             f"known: {sorted(EMNIST_SPLITS)}")
        tag, self.n_classes = EMNIST_SPLITS[split]
        root = root or os.path.join(data_dir(), "emnist")
        kind = "train" if train else "test"
        img = MnistDataFetcher._find(root, f"emnist-{tag}-{kind}-images-idx3-ubyte")
        lab = MnistDataFetcher._find(root, f"emnist-{tag}-{kind}-labels-idx1-ubyte")
        self.images = _read_idx(img).astype(np.float32) / 255.0
        raw = _read_idx(lab).astype(np.int64)
        if split == "letters":  # letters labels are 1-indexed
            raw = raw - 1
        self.labels = np.eye(self.n_classes, dtype=np.float32)[raw]

    def arrays(self, flatten=False):
        x = self.images.reshape(len(self.images), -1) if flatten \
            else self.images[..., None]
        return x, self.labels


# ---------------------------------------------------------------------------
# CIFAR-10 (reference: CifarDataSetIterator over DataVec's CifarLoader —
# the canonical binary batch format: 1 label byte + 3072 channel-major bytes)
# ---------------------------------------------------------------------------

class Cifar10DataFetcher:
    """CIFAR-10 binary batches from <data_dir>/cifar10/ (data_batch_1..5.bin,
    test_batch.bin). Outputs NHWC float32 in [0,1]."""

    N_CLASSES = 10

    def __init__(self, train=True, root=None, limit=None):
        root = root or os.path.join(data_dir(), "cifar10")
        names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else ["test_batch.bin"]
        xs, ys = [], []
        for name in names:
            path = self._find(root, name)
            raw = np.frombuffer(open(path, "rb").read(), np.uint8)
            rec = raw.reshape(-1, 3073)
            ys.append(rec[:, 0].astype(np.int64))
            xs.append(rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.concatenate(ys)
        if limit:
            x, y = x[:limit], y[:limit]
        self.images = x
        self.labels = np.eye(self.N_CLASSES, dtype=np.float32)[y]

    @staticmethod
    def _find(root, name):
        for cand in (os.path.join(root, name),
                     os.path.join(root, "cifar-10-batches-bin", name)):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"CIFAR-10 file {name} not found under {root} (or its "
            f"cifar-10-batches-bin/ subdir). Nothing is downloaded: place the "
            f"binary-version batches there.")

    def arrays(self):
        return self.images, self.labels


# ---------------------------------------------------------------------------
# SVHN (reference: SvhnDataFetcher.java — cropped-digits .mat format)
# ---------------------------------------------------------------------------

class SvhnDataFetcher:
    """SVHN cropped digits from <data_dir>/svhn/{train,test}_32x32.mat.
    MATLAB label '10' means digit 0 (normalized here)."""

    N_CLASSES = 10

    def __init__(self, train=True, root=None, limit=None):
        import scipy.io
        root = root or os.path.join(data_dir(), "svhn")
        name = ("train" if train else "test") + "_32x32.mat"
        path = os.path.join(root, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"SVHN file {name} not found under {root}. Nothing is "
                f"downloaded: place the cropped-digits .mat files there.")
        mat = scipy.io.loadmat(path)
        x = mat["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0  # NHWC
        y = mat["y"].reshape(-1).astype(np.int64) % 10  # 10 -> 0
        if limit:
            x, y = x[:limit], y[:limit]
        self.images = x
        self.labels = np.eye(self.N_CLASSES, dtype=np.float32)[y]

    def arrays(self):
        return self.images, self.labels


# ---------------------------------------------------------------------------
# Tiny ImageNet (reference: TinyImageNetFetcher.java — 200 classes, 64x64)
# ---------------------------------------------------------------------------

class TinyImageNetFetcher:
    """tiny-imagenet-200 directory layout under <data_dir>/tiny-imagenet-200:
    wnids.txt, train/<wnid>/images/*.JPEG, val/images + val_annotations.txt."""

    SIZE = 64

    def __init__(self, train=True, root=None, limit=None):
        from PIL import Image
        root = root or os.path.join(data_dir(), "tiny-imagenet-200")
        wnids_file = os.path.join(root, "wnids.txt")
        if not os.path.exists(wnids_file):
            raise FileNotFoundError(
                f"tiny-imagenet-200/wnids.txt not found under {root}. "
                f"Nothing is downloaded: place the extracted dataset there.")
        wnids = [l.strip() for l in open(wnids_file) if l.strip()]
        self.n_classes = len(wnids)
        idx = {w: i for i, w in enumerate(wnids)}
        paths, labels = [], []
        if train:
            for w in wnids:
                d = os.path.join(root, "train", w, "images")
                if not os.path.isdir(d):
                    continue
                for fn in sorted(os.listdir(d)):
                    paths.append(os.path.join(d, fn))
                    labels.append(idx[w])
        else:
            ann = os.path.join(root, "val", "val_annotations.txt")
            for line in open(ann):
                parts = line.split("\t")
                if len(parts) >= 2 and parts[1] in idx:
                    paths.append(os.path.join(root, "val", "images", parts[0]))
                    labels.append(idx[parts[1]])
        if limit:
            paths, labels = paths[:limit], labels[:limit]
        imgs = []
        for p in paths:
            with Image.open(p) as im:
                imgs.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
        self.images = np.stack(imgs) if imgs else \
            np.zeros((0, self.SIZE, self.SIZE, 3), np.float32)
        self.labels = np.eye(self.n_classes, dtype=np.float32)[
            np.asarray(labels, np.int64)] if labels else \
            np.zeros((0, self.n_classes), np.float32)

    def arrays(self):
        return self.images, self.labels


# ---------------------------------------------------------------------------
# LFW (reference: LFWDataSetIterator via DataVec loader)
# ---------------------------------------------------------------------------

class LfwDataFetcher:
    """Labeled Faces in the Wild from <data_dir>/lfw/<person>/<imgs>.jpg.
    Labels are person identities (directory names, sorted)."""

    def __init__(self, root=None, image_size=64, min_images_per_person=1,
                 limit=None):
        from PIL import Image
        root = root or os.path.join(data_dir(), "lfw")
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"LFW directory not found at {root}. Nothing is downloaded: "
                f"place the extracted lfw/ person directories there.")
        people = sorted(d for d in os.listdir(root)
                        if os.path.isdir(os.path.join(root, d)))
        people = [p for p in people
                  if len(os.listdir(os.path.join(root, p)))
                  >= min_images_per_person]
        self.people = people
        idx = {p: i for i, p in enumerate(people)}
        imgs, labels = [], []
        for p in people:
            for fn in sorted(os.listdir(os.path.join(root, p))):
                imgs.append(os.path.join(root, p, fn))
                labels.append(idx[p])
        if limit:
            imgs, labels = imgs[:limit], labels[:limit]
        arrs = []
        for path in imgs:
            with Image.open(path) as im:
                im = im.convert("RGB").resize((image_size, image_size))
                arrs.append(np.asarray(im, np.float32) / 255.0)
        self.images = np.stack(arrs) if arrs else \
            np.zeros((0, image_size, image_size, 3), np.float32)
        self.labels = np.eye(len(people), dtype=np.float32)[
            np.asarray(labels, np.int64)] if labels else \
            np.zeros((0, len(people)), np.float32)

    def arrays(self):
        return self.images, self.labels


# ---------------------------------------------------------------------------
# UCI synthetic control (reference: UciSequenceDataFetcher.java — 600 series
# of 60 steps, 6 classes of 100 consecutive rows)
# ---------------------------------------------------------------------------

class UciSequenceDataFetcher:
    """synthetic_control.data from <data_dir>/uci/: 600 whitespace-separated
    rows of 60 floats; class c = rows [100c, 100(c+1)). Returns sequences
    [N, 60, 1] and one-hot labels [N, 6]; deterministic shuffled 450/150
    train/test split (reference behavior)."""

    N_CLASSES = 6
    SEQ_LEN = 60

    def __init__(self, train=True, root=None, seed=123):
        root = root or os.path.join(data_dir(), "uci")
        path = os.path.join(root, "synthetic_control.data")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"UCI synthetic_control.data not found under {root}. Nothing is "
                f"downloaded: place it there.")
        rows = np.loadtxt(path, dtype=np.float32)
        if rows.shape != (600, 60):
            raise ValueError(f"Expected 600x60 data, got {rows.shape}")
        labels = np.repeat(np.arange(6), 100)
        order = np.random.RandomState(seed).permutation(600)
        cut = 450
        sel = order[:cut] if train else order[cut:]
        # normalize per-series (zero mean, unit variance) for trainability
        x = rows[sel]
        x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
        self.sequences = x[..., None]
        self.labels = np.eye(6, dtype=np.float32)[labels[sel]]

    def arrays(self):
        return self.sequences, self.labels


def emnist_iterator(batch_size=128, split="balanced", train=True,
                    flatten=False, shuffle=True, seed=123):
    x, y = EmnistDataFetcher(split=split, train=train).arrays(flatten=flatten)
    return ArrayDataSetIterator(x, y, batch_size, shuffle=shuffle, seed=seed)


def cifar10_iterator(batch_size=128, train=True, shuffle=True, seed=123,
                     limit=None):
    x, y = Cifar10DataFetcher(train=train, limit=limit).arrays()
    return ArrayDataSetIterator(x, y, batch_size, shuffle=shuffle, seed=seed)


def svhn_iterator(batch_size=128, train=True, shuffle=True, seed=123,
                  limit=None):
    x, y = SvhnDataFetcher(train=train, limit=limit).arrays()
    return ArrayDataSetIterator(x, y, batch_size, shuffle=shuffle, seed=seed)


def tiny_imagenet_iterator(batch_size=128, train=True, shuffle=True,
                           seed=123, limit=None):
    x, y = TinyImageNetFetcher(train=train, limit=limit).arrays()
    return ArrayDataSetIterator(x, y, batch_size, shuffle=shuffle, seed=seed)


def uci_sequence_iterator(batch_size=64, train=True, shuffle=True, seed=123):
    x, y = UciSequenceDataFetcher(train=train).arrays()
    return ArrayDataSetIterator(x, y, batch_size, shuffle=shuffle, seed=seed)
