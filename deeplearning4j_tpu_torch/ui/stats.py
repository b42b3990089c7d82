"""Training statistics collection.

The port of ``deeplearning4j_tpu/ui/stats.py``. Reference analog:
deeplearning4j-ui-parent/deeplearning4j-ui-model/.../stats/
BaseStatsListener.java (iterationDone: score, parameter histograms and
norms, memory, hardware info every N iterations), encoded with SBE
(SbeStatsReport.java). Here the record is a plain dict serialized as JSON
lines by the storage layer, with the JAX package's keys.

The parameter reductions run where the parameters live: l2, mean, std
(population), min and max of every leaf in float32, stacked into one
``[leaves, 5]`` tensor that crosses to the host in ONE transfer a record
(no ``.item()`` per leaf), as the JAX module reduces the whole tree in one
jitted call and fetches the scalars once. Histograms follow the JAX bins,
``np.histogram`` of the leaf in float64 over its own min and max: like
the JAX module, the port copies each leaf to the host for them (counting
on the card would bin in float32, and a value on an edge could land in
the other bin), so ``collect_histograms`` costs a transfer a leaf and is
off by default.

The ``hardware`` and ``system`` records keep the JAX keys; their values
come from ``torch.cuda`` for a model on a card (its name, the caching
allocator's bytes in use, the card's total memory as the limit) and
``process`` from ``torch.distributed``'s rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.listeners import TrainingListener
from deeplearning4j_tpu_torch.utils.trees import flatten_tree

_STATS = ("l2", "mean", "std", "min", "max")


def _reduce(t):
    """[5] float32: l2, mean, population std, min, max of one leaf."""
    a = t.detach().reshape(-1).float()
    return torch.stack([torch.linalg.vector_norm(a), a.mean(), a.std(correction=0),
                        a.min(), a.max()])


def _array_stats(tree, histogram_bins=0):
    """``{keystr name: {l2, mean, std, min, max[, hist]}}`` over the
    non-empty leaves of a params-like tree. One host transfer for the
    scalars of every leaf on one device."""
    leaves = {name: leaf for name, leaf in flatten_tree(tree).items()
              if leaf is not None and int(np.prod(getattr(leaf, "shape", ()))) > 0}
    out = {}
    by_device = {}
    for name, leaf in leaves.items():
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        by_device.setdefault(t.device, []).append((name, t))
    for items in by_device.values():
        host = torch.stack([_reduce(t) for _, t in items]).cpu().numpy()
        for (name, _), row in zip(items, host):
            out[name] = {s: float(v) for s, v in zip(_STATS, row)}
    if histogram_bins:
        for name, leaf in leaves.items():
            a = (leaf.detach().double().cpu().numpy() if isinstance(leaf, torch.Tensor)
                 else np.asarray(leaf, np.float64)).ravel()
            counts, edges = np.histogram(a, bins=histogram_bins)
            out[name]["hist"] = {"counts": counts.tolist(),
                                 "min": float(edges[0]), "max": float(edges[-1])}
    return out


def _model_device(model):
    """The device of the model's first parameter (the CPU without one)."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    for leaf in tree_leaves(getattr(model, "params", None) or []):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class StatsListener(TrainingListener):
    """Collects per-iteration training telemetry into a StatsStorage."""

    def __init__(self, storage, *, frequency=1, session_id="default",
                 collect_histograms=False, histogram_bins=20):
        self.storage = storage
        self.frequency = frequency
        self.session_id = session_id
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self._last_time = None
        self._pending_times = []
        self._init_posted = False
        self._device = None

    def _post_init(self, model):
        # duck-typed over everything that fires iteration_done: plain
        # networks expose num_params()/conf, the parallel trainers and
        # pipeline classes a params tree
        self._device = _model_device(model)
        if model.params is None:
            n_params = 0
        elif hasattr(model, "num_params"):
            n_params = model.num_params()
        else:
            from deeplearning4j_tpu_torch.utils.trees import tree_leaves
            n_params = int(sum(int(np.prod(l.shape)) for l in tree_leaves(model.params)))
        conf = getattr(model, "conf", getattr(getattr(model, "net", None), "conf", None))
        info = {"type": "init", "session": self.session_id,
                "time": time.time(),
                "num_params": n_params,
                "num_layers": len(getattr(conf, "layers", ())) or
                len(getattr(conf, "vertices", ()))}
        import platform

        dev = self._device
        if dev.type == "cuda":
            info["hardware"] = {"platform": "gpu", "n_devices": torch.cuda.device_count(),
                                "device_kind": torch.cuda.get_device_name(dev),
                                "host": platform.platform(),
                                "python": platform.python_version()}
        else:
            info["hardware"] = {"platform": dev.type, "n_devices": 1, "device_kind": dev.type,
                                "host": platform.platform(),
                                "python": platform.python_version()}
        self.storage.put_record(info)
        self._init_posted = True

    @staticmethod
    def _process_index():
        """This process's rank in the default group, 0 without one."""
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    def _system_stats(self):
        """Host RSS and the card's memory (the reference system tab's
        memory series): the caching allocator's counters, read without a
        device call; absent for a model on the CPU."""
        out = {}
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        out["host_rss_mb"] = round(float(line.split()[1]) / 1024.0, 1)
                        break
        except OSError:
            try:
                import resource
                import sys
                rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                div = 1 << 20 if sys.platform == "darwin" else 1 << 10
                out["host_rss_mb"] = round(rss / div, 1)
            except Exception:  # noqa: BLE001 -- the series is optional
                pass
        dev = self._device
        if dev is not None and dev.type == "cuda":
            out["device_bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
            out["device_bytes_limit"] = int(torch.cuda.get_device_properties(dev).total_memory)
        return out

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        if not self._init_posted:
            self._post_init(model)
        # wall time EVERY iteration, so iter_time_s is per iteration even
        # when frequency > 1 (the reference's BaseStatsListener does the same)
        now = time.perf_counter()
        if self._last_time is not None:
            self._pending_times.append(now - self._last_time)
        self._last_time = now
        if iteration % self.frequency != 0:
            return
        rec = {"type": "stats", "session": self.session_id,
               "iteration": iteration, "time": time.time(),
               "score": float(score), "etl_time_s": float(etl_time)}
        proc = self._process_index()
        if proc:
            # multi-host runs: tag the worker so the system tab can split
            # series per process (reference: TrainModule's machine selector)
            rec["process"] = proc
        if self._pending_times:
            rec["iter_time_s"] = sum(self._pending_times) / len(self._pending_times)
            self._pending_times = []
        bins = self.histogram_bins if self.collect_histograms else 0
        if model.params is not None:
            rec["params"] = _array_stats(model.params, bins)
        rec["system"] = self._system_stats()
        self.storage.put_record(rec)

    def on_epoch_end(self, model):
        self.storage.put_record({"type": "epoch_end", "session": self.session_id,
                                 "epoch": model.epoch, "time": time.time()})
