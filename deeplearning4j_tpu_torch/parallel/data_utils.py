"""Distributed data plumbing: balanced sharding, batch export/reload.

The port's own copy of ``deeplearning4j_tpu/parallel/data_utils.py`` (numpy
only, unchanged). Reference analog: dl4j-spark's data package
(BatchAndExportDataSetsFunction, DataSetExportFunction,
PathToDataSetFunction, SplitDataSetsFunction) and
HashingBalancedPartitioner (class-balanced repartitioning so every worker
sees the label distribution, not a skewed slice).

Here "partitions" are the ranks of the mesh's data axis; the export format
is npz batch files that ``load_exported_batches`` streams back.
"""

from __future__ import annotations

import os

import numpy as np


def balanced_shard_assignment(labels, n_shards, seed=0):
    """Shard index per example such that every shard gets an (almost) equal
    share OF EACH CLASS — the HashingBalancedPartitioner contract, computed
    directly instead of via hash-jump probabilities (no distributed hash
    function is needed when the whole index fits in host memory).

    labels: int class ids [N] or one-hot [N, C]. Returns int32 [N].
    """
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = np.argmax(labels, axis=1)
    n = len(labels)
    rs = np.random.RandomState(seed)
    out = np.empty(n, np.int32)
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rs.shuffle(idx)
        # deal class members round-robin across shards, random start so
        # remainders don't always land on shard 0
        start = rs.randint(n_shards)
        out[idx] = (start + np.arange(len(idx))) % n_shards
    return out


def rebalance(features, labels, n_shards, seed=0):
    """Reorder (features, labels) so equal-size contiguous slices are
    class-balanced shards: slice i = examples [i*S, (i+1)*S). Drops at most
    n_shards-1 examples to equalize shard sizes (recorded in the return).

    Returns (features, labels, shard_size, dropped).
    """
    features = np.asarray(features)
    labels = np.asarray(labels)
    assign = balanced_shard_assignment(labels, n_shards, seed)
    order = np.argsort(assign, kind="stable")
    shard_size = len(labels) // n_shards
    shards, overflow = [], []
    pos = 0
    for s in range(n_shards):
        members = order[pos:pos + np.count_nonzero(assign == s)]
        pos += len(members)
        shards.append(list(members[:shard_size]))
        overflow.extend(members[shard_size:])
    # per-class round-robin can leave a shard underfull; top it up from the
    # overflow pool so every shard is EXACTLY shard_size (the pool always
    # suffices: total >= n_shards * shard_size)
    for s in range(n_shards):
        need = shard_size - len(shards[s])
        if need > 0:
            shards[s].extend(overflow[:need])
            overflow = overflow[need:]
    kept = np.concatenate([np.asarray(s, np.int64) for s in shards])
    dropped = len(labels) - len(kept)
    return features[kept], labels[kept], shard_size, dropped


def export_batches(features, labels, out_dir, batch_size, prefix="dataset"):
    """Write minibatch npz files (reference: BatchAndExportDataSetsFunction
    — batch the stream, export each batch to storage, return the paths)."""
    os.makedirs(out_dir, exist_ok=True)
    features = np.asarray(features)
    labels = np.asarray(labels)
    paths = []
    n_full = len(features) // batch_size
    for i in range(n_full):
        lo = i * batch_size
        p = os.path.join(out_dir, f"{prefix}_{i:06d}.npz")
        np.savez(p, features=features[lo:lo + batch_size],
                 labels=labels[lo:lo + batch_size])
        paths.append(p)
    return paths


def load_exported_batches(paths_or_dir, prefix="dataset"):
    """Iterate (features, labels) from exported npz batches (reference:
    PathToDataSetFunction — map paths back to DataSets)."""
    if isinstance(paths_or_dir, str):
        paths = sorted(
            os.path.join(paths_or_dir, f) for f in os.listdir(paths_or_dir)
            if f.startswith(prefix) and f.endswith(".npz"))
    else:
        paths = list(paths_or_dir)
    for p in paths:
        with np.load(p) as z:
            yield z["features"], z["labels"]


def split_dataset(features, labels, n_examples_per_split):
    """Split into consecutive (features, labels) chunks (reference:
    SplitDataSetsFunction — break large DataSets into per-worker pieces)."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    return [(features[i:i + n_examples_per_split],
             labels[i:i + n_examples_per_split])
            for i in range(0, len(features), n_examples_per_split)]
