"""Numerics watchdog: NaN/Inf detection, gradient-norm telemetry, policy.

The port of ``deeplearning4j_tpu/telemetry/health.py``:

* ``health_stats(grads, params, loss)`` folds the NaN/Inf flags, the global
  and per-layer gradient L2 norms and the per-layer grad-to-weight ratios
  into one dict of device scalars. ``make_train_step(with_health=True)``
  of both network kinds returns it from inside the step, with no host
  sync, so it also runs inside a captured CUDA graph (``nn/fused.py``,
  where each key comes back as a ``[K]`` tensor).
* ``HealthMonitor`` resolves the bundles one dispatch late (``on_step``
  queues dispatch *i* and resolves *i - 1*, one host transfer each) and
  runs the policy on an anomaly: ``record`` counts it, ``warn`` logs it,
  ``raise`` raises ``NumericsError``. ``flush`` drains the tail.

As the JAX monitor, it exports the registry gauges and counter
``train_grad_norm``, ``train_layer_grad_norm``, ``train_layer_gw_ratio``
and ``train_numerics_anomalies_total`` (when telemetry is on), annotates
each resolved step's flight-recorder record with its health fields (JAX
``health.py:243``) and dumps the flight ring once an anomaly streak (JAX
``:277``; a healthy step ends the streak, ``note_healthy``).
"""

from __future__ import annotations

import collections
import logging
import threading

import torch

from deeplearning4j_tpu_torch.telemetry import registry as _registry

logger = logging.getLogger("deeplearning4j_tpu_torch")

POLICIES = ("record", "warn", "raise")


class NumericsError(FloatingPointError):
    """Raised by the watchdog under ``policy='raise'``; carries the step
    index and the anomaly record."""

    def __init__(self, msg, step=None, record=None, flight_dump=None):
        super().__init__(msg)
        self.step = step
        self.record = record
        self.flight_dump = flight_dump


def _named_groups(tree):
    """Top-level (name, subtree) pairs: a MultiLayerNetwork's list of
    per-layer dicts as ('0', ...), ('1', ...); a graph's vertex names."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return list(tree.items())
    return [(str(i), g) for i, g in enumerate(tree)]


def _leaves(tree):
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves
    return list(tree_leaves(tree))


def tree_sq_sum(tree, device=None):
    """Sum of squares over every leaf, in float32, as a 0-d tensor."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32, device=device)
    return sum((l.detach().float() ** 2).sum() for l in leaves)


def any_nonfinite(tree, device=None):
    """0-d bool tensor: does any leaf hold a NaN or an Inf?"""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.bool, device=device)
    flag = ~torch.isfinite(leaves[0].detach()).all()
    for l in leaves[1:]:
        flag = flag | ~torch.isfinite(l.detach()).all()
    return flag


def health_stats(grads, params, loss):
    """One health bundle, a flat dict of 0-d device tensors: ``loss``,
    ``loss_nonfinite``, ``grad_nonfinite``, ``grad_norm`` and, per
    top-level group, ``layer/<name>/grad_norm`` and ``layer/<name>/gw_ratio``
    (gradient L2 norm over parameter L2 norm)."""
    loss32 = loss.detach().float()
    dev = loss32.device
    bundle = {"loss": loss32, "loss_nonfinite": ~torch.isfinite(loss32),
              "grad_nonfinite": any_nonfinite(grads, dev)}
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for (name, g), (_, p) in zip(_named_groups(grads), _named_groups(params)):
        gsq = tree_sq_sum(g, dev)
        total = total + gsq
        gn = torch.sqrt(gsq)
        bundle[f"layer/{name}/grad_norm"] = gn
        # a group without parameters has no gradients either: 0 / eps = 0
        bundle[f"layer/{name}/gw_ratio"] = gn / (torch.sqrt(tree_sq_sum(p, dev)) + 1e-12)
    bundle["grad_norm"] = torch.sqrt(total)
    return bundle


class HealthMonitor:
    """Process-wide watchdog consuming the fit loops' health bundles."""

    def __init__(self, max_anomalies=32):
        self._lock = threading.RLock()
        self.max_anomalies = int(max_anomalies)
        self._defaults()

    def _defaults(self):
        self.active = False
        self.policy = "record"
        self.grad_norm_limit = None
        self.anomalies = collections.deque(maxlen=self.max_anomalies)
        self.nonfinite_steps = 0
        self.steps_checked = 0
        self.last = None
        self._pending = None
        self._dumped = False  # one flight dump per anomaly streak

    def enable(self, policy="record", grad_norm_limit=None):
        """Arm the watchdog. ``policy``: 'record' | 'warn' | 'raise';
        ``grad_norm_limit``: an optional bound on the global gradient norm
        (NaN and Inf always count as anomalies)."""
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        with self._lock:
            self.active = True
            self.policy = policy
            self.grad_norm_limit = None if grad_norm_limit is None else float(grad_norm_limit)
            self._dumped = False  # re-arming starts a fresh dump streak
        return self

    def disable(self):
        with self._lock:
            self.active = False
        return self

    def reset(self):
        """Back to the cold state (test isolation)."""
        with self._lock:
            self._defaults()
        return self

    def _instruments(self):
        reg = _registry.get_registry()
        return (reg,
                reg.gauge("train_grad_norm",
                          "global gradient L2 norm (numerics watchdog)"),
                reg.gauge("train_layer_grad_norm",
                          "per-layer gradient L2 norm, labeled by layer"),
                reg.gauge("train_layer_gw_ratio",
                          "per-layer grad-to-weight L2 ratio "
                          "(update/weight proxy), labeled by layer"),
                reg.counter("train_numerics_anomalies_total",
                            "watchdog anomalies observed, labeled by kind"))

    def on_step(self, bundle, **meta):
        """Queue this dispatch's bundle; resolve the previous one (its
        policy acts one dispatch late, never lost: ``flush`` drains)."""
        with self._lock:
            prev, self._pending = self._pending, (bundle, meta)
        if prev is not None:
            self._resolve(*prev)

    def flush(self, apply_policy=True):
        """Resolve the pending bundle. ``apply_policy=False`` records it
        without warning or raising (an exception is already on its way)."""
        with self._lock:
            prev, self._pending = self._pending, None
        if prev is not None:
            self._resolve(*prev, apply_policy=apply_policy)

    def _resolve(self, bundle, meta, apply_policy=True):
        keys = list(bundle)
        # one transfer for every key (and, stacked, every step)
        vals = torch.stack([bundle[k].detach().double() for k in keys]).cpu().numpy()
        if vals.ndim == 2:
            # a K-step dispatch: one record a step, the padded K-tail's dropped
            k = min(int(meta.get("k") or vals.shape[1]), vals.shape[1])
            step0 = meta.get("step")
            for j in range(k):
                self._consume(self._record(keys, vals[:, j]),
                              None if step0 is None else step0 + j, apply_policy)
            return
        self._consume(self._record(keys, vals), meta.get("step"), apply_policy)

    @staticmethod
    def _record(keys, column):
        return {k: (bool(v) if k.endswith("nonfinite") else float(v))
                for k, v in zip(keys, column)}

    def _consume(self, rec, step, apply_policy=True):
        reg, g_norm, g_layer, g_ratio, _ = self._instruments()
        if reg.enabled:
            g_norm.set(rec["grad_norm"])
            for k, v in rec.items():
                if k.startswith("layer/"):
                    _, name, kind = k.split("/", 2)
                    (g_layer if kind == "grad_norm" else g_ratio).set(v, layer=name)
        flat = {k: v for k, v in rec.items() if not k.startswith("layer/")}
        with self._lock:
            self.steps_checked += 1
            self.last = {"step": step, **flat}
        # annotate the flight-recorder ring BEFORE any dump so the offending
        # step's record carries its health fields in the postmortem
        from deeplearning4j_tpu_torch.telemetry import flight as _flight
        _flight.get_recorder().annotate(step, **flat)
        nonfinite = rec["loss_nonfinite"] or rec["grad_nonfinite"]
        exploded = self.grad_norm_limit is not None and rec["grad_norm"] > self.grad_norm_limit
        if nonfinite or exploded:
            self.note_anomaly("nonfinite" if nonfinite else "grad_norm_limit", step=step,
                              apply_policy=apply_policy, **flat)
        else:
            self.note_healthy()

    def note_healthy(self):
        """A healthy observation ends the current anomaly streak: the next
        anomaly is a new incident and earns its own flight dump."""
        with self._lock:
            self._dumped = False

    def note_anomaly(self, kind, step=None, apply_policy=True, **fields):
        """Record one anomaly and run the policy; the first of a streak
        dumps the flight ring."""
        a = {"kind": kind, "step": step, **fields}
        with self._lock:
            self.nonfinite_steps += 1
            self.anomalies.append(a)
            first = not self._dumped
            self._dumped = True
        *_, c_anom = self._instruments()
        c_anom.inc(kind=kind)
        from deeplearning4j_tpu_torch.telemetry import flight as _flight
        path = None
        if first:
            # one dump per anomaly streak: once the params are NaN every
            # later step is anomalous, and a dump a step would bury the
            # postmortem under identical files
            path = _flight.get_recorder().dump(reason=f"numerics:{kind}", extra={"anomaly": a})
        if not apply_policy:
            return a
        msg = (f"numerics watchdog: {kind} at step {step} "
               f"(loss={fields.get('loss')}, grad_norm={fields.get('grad_norm')})")
        if self.policy == "warn":
            logger.warning("%s%s", msg, f" [flight dump: {path}]" if path else "")
        elif self.policy == "raise":
            raise NumericsError(msg, step=step, record=a, flight_dump=path)
        return a

    def summary(self):
        """The watchdog's state as plain JSON types."""
        with self._lock:
            return {"active": self.active, "policy": self.policy,
                    "steps_checked": self.steps_checked,
                    "nonfinite_steps": self.nonfinite_steps,
                    "last": dict(self.last) if self.last else None,
                    "anomalies": [dict(a) for a in self.anomalies]}


_monitor = HealthMonitor()


def get_monitor():
    return _monitor


def enable(policy="record", grad_norm_limit=None):
    """Arm the process-wide watchdog (the next fit picks it up)."""
    return _monitor.enable(policy=policy, grad_norm_limit=grad_norm_limit)


def disable():
    return _monitor.disable()
