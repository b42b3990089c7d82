"""K training steps a dispatch: the fused engine.

The port of ``deeplearning4j_tpu/nn/fused.py``. On the JAX side K steps
run under one ``lax.scan``; here they run as one CUDA graph:

* ``make_train_steps(net, k)`` builds the engine, a callable

      (params, state, opt_state, xs[K, B, ...], ys, step0, seed, masks,
       step_valid[K]) -> losses[K] (, health {key: [K]})

  over the net's single train step (``net.make_train_step``). Params,
  layer state and updater state are carried in place in the net's own
  tensors; the iteration counter (``step0 + i``) and the seed chain
  (``step_seed(seed, step0 + i)``) advance on the device, and each step's
  updater scalars come from a ``[K, n]`` table the host computes from
  ``step0`` (``Updater.step_table``) and stages with the super-batch.
* The K-tail: a step whose ``step_valid`` is 0 (a padded tail of a ragged
  epoch) leaves params, state and updater state as they were: the carry is
  kept with ``torch.where``, not only masked out of the loss (a zero-mask
  step still has regularization gradients and updater decay).
* On a card the K steps are captured once per input signature into one
  ``torch.cuda.CUDAGraph`` over static input buffers, and one ``replay()``
  is one dispatch: each call copies the super-batch, masks, ``step_valid``,
  ``step0`` and the scalar table into the buffers, then replays. Before
  the capture the steps run twice eagerly on a side stream with every
  ``step_valid`` 0 (which changes nothing), so the kernels are built, their
  attributes set and cuDNN's algorithms chosen outside the capture. A CUDA
  net never runs the eager engine: a refused capture raises.
* A graph reads and writes the addresses it captured. The engine keeps its
  graphs per signature and rebuilds one when the net's parameter, state
  or updater-state tensors are no longer the ones it captured (after
  ``StepDriver.restore``, ``load_model`` or a K=1 fit that rebound the
  state), never at epoch ends or on ragged tails (``captures`` counts the
  builds). The outputs are copied out of the graph's memory after each
  replay, since the next replay overwrites them.
* The kernel wrappers count launches in Python, which a replay does not
  run: the launches the capturing thread counted (``ops/_build.py
  launch_tally``) are taken back and added once per replay
  (``replay_launches`` keeps the replays' share). The capture is
  thread-local (``capture_error_mode="thread_local"``), so another thread
  of the process, a serving engine answering beside a continuous trainer,
  may use the card while a signature is captured.
* On the CPU (tests) the same step function runs eagerly over the same
  static buffers: the engine's plain version.
* A signature warms (its capture, or its first eager run) through
  ``utils/compile_cache.aot_compile`` under the JAX package's kind
  ``fused:k=<K>:health=<0|1>``: with a warm manifest attached to the net,
  the kernel libraries come from it and the launch plans are seeded from
  it (no nvcc run, no tuning lookup); the capture itself still runs and
  counts in ``captures``.

Caveat (the JAX package's): padding is exact for the loss and gradients,
but batch-statistics layers (BatchNormalization in train mode) see the
zero rows of a padded batch in their moments.
"""

from __future__ import annotations

import importlib

import torch

from deeplearning4j_tpu_torch.nn.layers.base import step_seed
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.utils.device import as_device
from deeplearning4j_tpu_torch.utils.trees import tree_leaves

__all__ = ["make_train_steps", "fit_fused", "replay_launches"]

#: warm-up runs of the steps before a capture (all steps no-ops)
WARMUP_RUNS = 2
#: the modules whose kernel launches are counted
_COUNTED = ("conv_stats", "lstm_seq", "attention")
#: launches made by graph replays, by counter: {"conv_stats.conv_mm_stats": n, ...}
replay_launches = {}


def _counters():
    """{counter name: (module, dict name or None, key)} of every launch
    counter of the kernel wrappers."""
    out = {}
    for name in _COUNTED:
        mod = importlib.import_module(f"deeplearning4j_tpu_torch.ops.{name}")
        if isinstance(mod.launches, dict):
            for k in mod.launches:
                out[f"{name}.{k}"] = (mod, "launches", k)
        else:
            out[name] = (mod, None, "launches")
        for k in mod.launches_by_variant:
            out[f"{name}.variant.{k}"] = (mod, "launches_by_variant", k)
    return out


def _add_launches(delta, sign=1):
    for n, c in _counters().items():
        d = delta.get(n, 0)
        if not d:
            continue
        mod, dn, k = c
        with mod._count_lock:
            if dn:
                getattr(mod, dn)[k] += sign * d
            else:
                setattr(mod, k, getattr(mod, k) + sign * d)


def reset_replay_launches():
    replay_launches.clear()


def _tmap(fn, *trees):
    """``fn`` over tensors or dicts of them, entry by entry."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class _Signature:
    """One input signature's static buffers, its graph and its outputs."""

    def __init__(self, engine, xs, ys, ms, device):
        k = engine.k
        self.xs = _tmap(lambda a: torch.zeros(tuple(a.shape), dtype=_dtype(a), device=device), xs)
        self.ys = _tmap(lambda a: torch.zeros(tuple(a.shape), dtype=_dtype(a), device=device), ys)
        self.ms = torch.zeros(tuple(ms.shape), dtype=_dtype(ms), device=device)
        self.sv = torch.zeros(k, dtype=torch.float32, device=device)
        self.step0 = torch.zeros((), dtype=torch.int64, device=device)
        n = engine.table_width
        self.table = torch.zeros((k, n), dtype=torch.float32, device=device)
        self.graph = None
        self.out = None
        self.ptrs = None
        self.launches = {}
        self.warmed = False  # the eager engine's first run done


def _by_dtype(leaves):
    """``leaves`` grouped by dtype, in order."""
    groups = {}
    for t in leaves:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _flat(tensors):
    """The tensors' values in one flat tensor (one concatenation)."""
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _keep(valid, group, new, old):
    """``group``'s tensors set to ``new`` where the step is valid and to
    ``old`` where it is not (both flat, in ``group``'s order): one
    ``where`` and one multi-tensor copy for the whole group, where a copy a
    tensor would put hundreds of small kernels into every captured step."""
    kept = torch.where(valid, new, old)
    torch._foreach_copy_(group, [v.view_as(t) for v, t in
                                 zip(kept.split([t.numel() for t in group]), group)])


def _dtype(a):
    if torch.is_tensor(a):
        return a.dtype
    return torch.from_numpy(a[:0].copy()).dtype


class TrainSteps:
    """The K-step engine over one net (see the module docstring)."""

    def __init__(self, net, k, with_health=False, base_step=None, eager=False):
        if base_step is not None and with_health:
            raise ValueError(
                "make_train_steps: base_step and with_health=True don't compose: an "
                "injected step returns (params, state, opt_state, loss) without the health "
                "bundle; build the health variant into base_step or leave it to "
                "net.make_train_step")
        self.net = net
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.with_health = bool(with_health)
        self.base = base_step if base_step is not None else net.make_train_step(
            with_health=with_health)
        self.table_width = net.conf.updater.step_table([0]).shape[1]
        # a base step whose collectives cannot be captured (gloo) runs
        # eagerly on a card too, and builds no signature's graph
        self.eager = bool(eager)
        self.calls = 0      # engine calls: one a dispatch
        self.captures = 0   # signatures built (graphs captured on a card); 0 when eager
        self.replays = 0
        self._sigs = {}

    # -- the steps ------------------------------------------------------

    def _steps(self, params, state, opt_state, sig, seed):
        """The K steps over the static buffers, as captured and as run on
        the CPU. Returns (losses [K], health {key: [K]} or None)."""
        carried = _by_dtype(list(tree_leaves(params)) + list(tree_leaves(opt_state)))
        state_leaves = list(tree_leaves(state))
        losses, bundles = [], []
        for i in range(self.k):
            valid = sig.sv[i] > 0
            x = _tmap(lambda a: a[i], sig.xs)
            y = _tmap(lambda a: a[i], sig.ys)
            rng = step_seed(seed, sig.step0 + i)
            with torch.no_grad():
                before = [_flat(group) for group in carried]
            out = self.base(params, state, opt_state, x, y, sig.table[i], sig.ms[i], rng)
            new_state, loss = out[1], out[3]
            new_leaves = list(tree_leaves(new_state))
            if len(new_leaves) != len(state_leaves):
                raise ValueError("the train step changed the layer state's structure")
            with torch.no_grad():
                for group, old in zip(carried, before):
                    _keep(valid, group, _flat(group), old)
                pairs = [(t, n) for t, n in zip(state_leaves, new_leaves) if n is not t]
                for group in _by_dtype([t for t, _ in pairs]):
                    new = dict((id(t), n) for t, n in pairs)
                    _keep(valid, group, _flat([new[id(t)] for t in group]), _flat(group))
            losses.append(loss.detach())
            if self.with_health:
                bundles.append(out[4])
        health = None
        if self.with_health:
            health = {key: torch.stack([b[key] for b in bundles]) for key in bundles[0]}
        return torch.stack(losses), health

    # -- dispatch -------------------------------------------------------

    def _signature(self, xs, ys, ms, seed, device):
        def shapes(tree):
            if isinstance(tree, dict):
                return tuple((k, tuple(v.shape), str(_dtype(v))) for k, v in tree.items())
            return (tuple(tree.shape), str(_dtype(tree)))
        return (shapes(xs), shapes(ys), shapes(ms), int(seed), str(device))

    def _ptrs(self, params, state, opt_state):
        return tuple(t.data_ptr() for tree in (params, state, opt_state)
                     for t in tree_leaves(tree))

    def __call__(self, params, state, opt_state, xs, ys, step0, seed, masks, step_valid):
        net = self.net
        device = net.device
        self.calls += 1
        key = self._signature(xs, ys, masks, seed, device)
        ptrs = self._ptrs(params, state, opt_state)
        sig = self._sigs.get(key)
        if sig is None or sig.ptrs != ptrs:
            # new signature, or the net's tensors were replaced: a graph over
            # the old addresses would write into dead memory
            self._sigs.pop(key, None)
            sig = _Signature(self, xs, ys, masks, device)
            sig.ptrs = ptrs
            self._sigs[key] = sig
            self.captures += 0 if self.eager else 1
        with torch.no_grad():
            _tmap(lambda dst, src: dst.copy_(as_device(src, device), non_blocking=True),
                  sig.xs, xs)
            _tmap(lambda dst, src: dst.copy_(as_device(src, device), non_blocking=True),
                  sig.ys, ys)
            sig.ms.copy_(as_device(masks, device), non_blocking=True)
            sig.sv.copy_(as_device(torch.as_tensor(step_valid, dtype=torch.float32), device),
                         non_blocking=True)
            sig.step0.fill_(int(step0))
            table = net.conf.updater.step_table(range(int(step0), int(step0) + self.k))
            sig.table.copy_(as_device(torch.from_numpy(table), device), non_blocking=True)
        if device.type != "cuda" or self.eager:
            if not sig.warmed:
                # the signature's first run is its warm-up
                sig.warmed = True
                out, _src = self._warm(lambda: self._steps(params, state, opt_state, sig, seed),
                                       params, state, opt_state, xs, ys, masks)
                return self._finish(out)
            return self._finish(self._steps(params, state, opt_state, sig, seed))
        if sig.graph is None:
            self._warm(lambda: self._capture(params, state, opt_state, sig, seed, device),
                       params, state, opt_state, xs, ys, masks)
        sig.graph.replay()
        self.replays += 1
        _add_launches(sig.launches)
        for n, d in sig.launches.items():
            replay_launches[n] = replay_launches.get(n, 0) + d
        losses, health = sig.out
        # copies: the next replay overwrites the graph's outputs
        return self._finish((losses.clone(), None if health is None
                             else {k: v.clone() for k, v in health.items()}))

    def _warm(self, fn, params, state, opt_state, xs, ys, masks):
        """Warm a new signature through ``utils/compile_cache.aot_compile``
        under the JAX package's kind: a warm manifest attached to the net
        (``attach_manifest``, ``load_bundle``) installs its libraries and
        seeds its plans first; a live warm-up is written back into it."""
        from deeplearning4j_tpu_torch.utils import compile_cache as _cc
        return _cc.aot_compile(
            fn, manifest=getattr(self.net, "_warm_manifest", None),
            kind=f"fused:k={self.k}:health={int(self.with_health)}",
            signature=_cc.signature_of((params, state, opt_state, xs, ys, masks)))

    def _finish(self, out):
        losses, health = out
        return (losses, health) if self.with_health else losses

    def _capture(self, params, state, opt_state, sig, seed, device):
        """Warm up on a side stream with every step a no-op, then capture
        the K steps into one graph."""
        cur = torch.cuda.current_stream(device)
        valid = sig.sv.clone()
        sig.sv.zero_()
        side = torch.cuda.Stream(device=device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._steps(params, state, opt_state, sig, seed)
        cur.wait_stream(side)
        sig.sv.copy_(valid)
        graph = torch.cuda.CUDAGraph()
        # thread-local capture: another thread of the process (a serving
        # engine answering while a continuous trainer captures) may use the
        # card meanwhile without invalidating the capture, and only this
        # thread's launches are the graph's
        with _build.launch_tally() as tally:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._steps(params, state, opt_state, sig, seed)
        # the wrappers counted the captured launches, which have not run
        sig.launches = dict(tally)
        _add_launches(sig.launches, -1)
        sig.graph, sig.out = graph, out


def make_train_steps(net, k, with_health=False, base_step=None, eager=False):
    """The K-step engine over ``net``'s train step (see the module
    docstring). ``base_step`` substitutes the single step (the signature of
    ``net.make_train_step()``: the seam a sharded trainer injects its step
    through); it does not compose with ``with_health``. ``eager`` runs the
    steps without a CUDA graph on a card too (a base step whose
    collectives cannot be captured; ``captures`` stays 0)."""
    return TrainSteps(net, k, with_health=with_health, base_step=base_step, eager=eager)


def _steps_fn_for(net, k, with_health):
    """The net's cached engine for (k, with_health): one engine, and so one
    set of graphs, across fits."""
    cache = net.__dict__.setdefault("_train_steps_fused", {})
    key = (int(k), bool(with_health))
    if key not in cache:
        cache[key] = make_train_steps(net, k, with_health=with_health)
    return cache[key]


def fit_fused(net, batch_factory, *, epochs, k, batch_size=None, prefetch=True):
    """The K-step fit loop both network kinds' ``fit(steps_per_dispatch=K)``
    call: ``batch_factory`` returns a fresh ``(x, y, mask)`` iterable an
    epoch; the loop is ``continuous.driver.StepDriver``'s."""
    from deeplearning4j_tpu_torch.continuous.driver import StepDriver
    return StepDriver(net, batch_factory, k=k, batch_size=batch_size,
                      prefetch=prefetch).run(epochs)
