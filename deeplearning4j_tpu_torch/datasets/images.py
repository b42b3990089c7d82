"""Image directory loading: the DataVec ImageRecordReader role, the port's
copy of ``deeplearning4j_tpu/datasets/images.py``.

Directory-per-class image trees (ImageRecordReader with a
ParentPathLabelGenerator): NHWC float32 in [0, 255] with one-hot labels
from the sorted parent directory names. Decoding goes through PIL, which
is imported only when an image is read.
"""

from __future__ import annotations

import os

import numpy as np


def load_image(path, *, height=None, width=None, channels=3):
    """[H, W, C] float32 in [0, 255] (use datasets.normalizers.
    ImagePreProcessingScaler for 0-1 scaling, like the reference)."""
    from PIL import Image

    if channels not in (1, 3, 4):
        raise ValueError(f"channels must be 1, 3 or 4, got {channels}")
    if (height is None) != (width is None):
        raise ValueError("pass BOTH height and width to resize (got "
                         f"height={height}, width={width})")
    img = Image.open(path)
    img = img.convert({1: "L", 3: "RGB", 4: "RGBA"}[channels])
    if height is not None:
        img = img.resize((width, height))
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def image_dataset(root, *, height, width, channels=3, extensions=None):
    """(images [N, H, W, C], labels [N, n_classes], class_names) from a
    directory-per-class tree — the ImageRecordReader +
    ParentPathLabelGenerator contract. Classes are the sorted child
    directory names; every readable image under each contributes one
    example."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"{root}: no class subdirectories")
    exts = tuple(e.lower() for e in (extensions
                                     or ("bmp", "png", "jpg", "jpeg",
                                         "gif")))
    xs, ys = [], []
    for ci, cname in enumerate(classes):
        # extension match is case-insensitive (.BMP/.JPG from cameras)
        files = sorted(
            os.path.join(root, cname, f) for f in
            os.listdir(os.path.join(root, cname))
            if "." in f and f.rsplit(".", 1)[1].lower() in exts)
        if not files:
            raise ValueError(f"{root}/{cname}: no images matching {exts}")
        for p in files:
            xs.append(load_image(p, height=height, width=width,
                                 channels=channels))
            ys.append(ci)
    x = np.stack(xs)
    y = np.eye(len(classes), dtype=np.float32)[np.asarray(ys)]
    return x, y, classes
