"""graftsan for the port (``deeplearning4j_tpu_torch/analysis/sanitizer.py``),
the twin of ``tests/test_sanitizer.py``: the runtime concurrency sanitizer
detects lock inversions (without needing a real deadlock), leaked
non-daemon threads, never-resolved ``InferenceFuture``s of the port's
serving engine and cross-thread RMW outside any tracked lock, and stays
silent on the disciplined twins — on synthetic locks, on a fleet-style
lock pair and on the port's serving engine serving on the CPU.

Each test builds its own Sanitizer. The ``graftsan`` fixture below wires
one around a test of the port's own threaded code; an ambient sanitizer
of either package is suspended first, because only one may own the
``threading`` patch at a time.
"""

import json
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import sanitizer as jax_sanitizer
from deeplearning4j_tpu_torch.analysis.sanitizer import (Sanitizer, _LockProxy,
                                                         merge_report)

#: scope that wraps locks allocated from THIS test module
HERE = (__name__, "tests.test_torch_sanitizer", "deeplearning4j_tpu_torch")


@pytest.fixture(autouse=True)
def _suspend_ambient_graftsan():
    for cls in (jax_sanitizer.Sanitizer, Sanitizer):
        if cls._active is not None:
            cls._active.uninstall()
    yield


@pytest.fixture
def graftsan():
    """The port's sanitizer around one test of its threaded code (locks of
    ``deeplearning4j_tpu_torch.*`` and of this module recorded, futures
    tracked); the test fails at teardown on any finding."""
    san = Sanitizer(scope_prefixes=HERE).install()
    try:
        yield san
        findings = san.check()
    finally:
        san.uninstall()
    assert findings == [], "graftsan findings:\n" + "\n".join(f.human() for f in findings)


# ----------------------------------------------------------------------
# lifecycle
# ----------------------------------------------------------------------

def test_install_patches_and_uninstall_restores():
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    san = Sanitizer(scope_prefixes=HERE)
    san.install()
    try:
        assert threading.Lock is not orig_lock
        assert isinstance(threading.Lock(), _LockProxy)
    finally:
        san.uninstall()
    assert threading.Lock is orig_lock
    assert threading.RLock is orig_rlock


def test_second_install_refused():
    with Sanitizer(scope_prefixes=HERE):
        with pytest.raises(RuntimeError):
            Sanitizer(scope_prefixes=HERE).install()


def test_default_scope_is_the_port_alone():
    """The default scope wraps the port's allocations, not the JAX
    package's (whose name is a prefix of the port's)."""
    assert Sanitizer().scope == ("deeplearning4j_tpu_torch",)
    with Sanitizer(scope_prefixes=("some.other.package",)):
        lock = threading.Lock()
    assert not isinstance(lock, _LockProxy)


def test_proxy_survives_uninstall():
    with Sanitizer(scope_prefixes=HERE) as san:
        lock = threading.Lock()
    assert isinstance(lock, _LockProxy)
    with lock:
        assert lock.locked()
    assert not lock.locked()
    assert san.check() == []


# ----------------------------------------------------------------------
# lock-inversion
# ----------------------------------------------------------------------

class _Router:
    """A fleet-style pair: a router that asks its supervisor for workers
    while holding its own lock, and a supervisor that pushes into the
    router while holding its own (fleet/router.py, fleet/supervisor.py
    keep these two orders apart; the inverted twin does not)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sup = None

    def route(self):
        with self._lock:
            return self.sup.workers()

    def attach_locked(self, workers):
        with self._lock:
            self.workers = list(workers)


class _Supervisor:
    def __init__(self, router):
        self._lock = threading.Lock()
        self.router = router
        router.sup = self

    def workers(self):
        with self._lock:
            return [0, 1]

    def respawn_inverted(self):
        with self._lock:             # supervisor -> router: the inversion
            self.router.attach_locked([0, 1])

    def respawn(self):
        ws = self.workers()           # take the list, drop the lock, then push
        self.router.attach_locked(ws)


def _on_thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(5.0)
    assert not t.is_alive()


@pytest.mark.parametrize("inverted", [True, False])
def test_fleet_style_lock_pair(inverted):
    with Sanitizer(scope_prefixes=HERE) as san:
        router = _Router()
        sup = _Supervisor(router)
        router.route()                                     # router -> supervisor
        _on_thread(sup.respawn_inverted if inverted else sup.respawn)
        finds = [f for f in san.check() if f.kind == "lock-inversion"]
    assert len(finds) == (1 if inverted else 0)
    if inverted:
        assert "opposite" in finds[0].message


def test_opposite_orders_report_without_deadlocking():
    with Sanitizer(scope_prefixes=HERE) as san:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        done = threading.Event()

        def rev():
            with b:
                with a:
                    pass
            done.set()

        _on_thread(rev)
        assert done.is_set()
        finds = [f for f in san.check() if f.kind == "lock-inversion"]
        assert len(finds) == 1


def test_rlock_reentry_is_not_an_edge():
    with Sanitizer(scope_prefixes=HERE) as san:
        lock = threading.RLock()
        with lock:
            with lock:
                pass
        assert san.check() == []
        assert san.report()["lock_order_edges"] == []


def test_cross_thread_release_clears_the_acquirer_stack():
    with Sanitizer(scope_prefixes=HERE) as san:
        a = threading.Lock()
        b = threading.Lock()
        acquired, released = threading.Event(), threading.Event()

        def acquirer():
            a.acquire()
            acquired.set()
            assert released.wait(5.0)
            with b:        # a is NOT held anymore: no edge
                pass

        t = threading.Thread(target=acquirer, daemon=True)
        t.start()
        assert acquired.wait(5.0)
        a.release()        # handoff release from the main thread
        released.set()
        t.join(5.0)
        assert san.report()["lock_order_edges"] == []
        assert san.check() == []


def test_report_keys_edges_by_allocation_site():
    with Sanitizer(scope_prefixes=HERE) as san:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        edges = san.report()["lock_order_edges"]
    assert len(edges) == 1 and edges[0]["count"] == 1
    assert "test_torch_sanitizer.py" in edges[0]["from"]


# ----------------------------------------------------------------------
# leaked threads
# ----------------------------------------------------------------------

def test_leaked_non_daemon_thread_reported():
    with Sanitizer(scope_prefixes=HERE) as san:
        ev = threading.Event()
        t = threading.Thread(target=ev.wait, name="leaky-worker")
        t.start()
        try:
            finds = [f for f in san.check() if f.kind == "leaked-thread"]
        finally:
            ev.set()
            t.join(5.0)
    assert len(finds) == 1 and "leaky-worker" in finds[0].message


def test_joined_and_daemon_threads_clean():
    with Sanitizer(scope_prefixes=HERE) as san:
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join(5.0)
        ev = threading.Event()
        d = threading.Thread(target=ev.wait, daemon=True)
        d.start()
        try:
            assert [f for f in san.check() if f.kind == "leaked-thread"] == []
        finally:
            ev.set()
            d.join(5.0)


# ----------------------------------------------------------------------
# cross-thread RMW
# ----------------------------------------------------------------------

class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0


def _run_writers(fn, n=2):
    # sequential short-lived threads on purpose: CPython reuses thread
    # idents the moment a thread exits
    for _ in range(n):
        _on_thread(fn)


def test_unlocked_cross_thread_writes_fire():
    with Sanitizer(scope_prefixes=HERE) as san:
        c = _Counter()
        assert san.watch_rmw(c, "count")
        _run_writers(lambda: setattr(c, "count", c.count + 1))
        finds = [f for f in san.check() if f.kind == "unlocked-rmw"]
    assert len(finds) == 1 and "_Counter.count" in finds[0].message


def test_locked_cross_thread_writes_clean():
    with Sanitizer(scope_prefixes=HERE) as san:
        c = _Counter()

        def bump():
            with c._lock:
                c.count = c.count + 1

        assert san.watch_rmw(c, "count")
        _run_writers(bump)
        assert c.count == 2
        assert [f for f in san.check() if f.kind == "unlocked-rmw"] == []


def test_single_thread_and_unwatched_writes_clean():
    with Sanitizer(scope_prefixes=HERE) as san:
        c = _Counter()
        assert san.watch_rmw(c, "count")
        for _ in range(5):
            c.count += 1
        _run_writers(lambda: setattr(c, "other", 1))
        assert san.check() == []


# ----------------------------------------------------------------------
# the port's serving engine: futures and a sanitized burst
# ----------------------------------------------------------------------

def test_unresolved_inference_future_reported_resolved_clean():
    from deeplearning4j_tpu_torch.serving.engine import InferenceFuture

    with Sanitizer(scope_prefixes=HERE) as san:
        kept = InferenceFuture()
        ok = InferenceFuture()
        ok._set(1)
        failed = InferenceFuture()
        failed._set_error(RuntimeError("x"))
        finds = [f for f in san.check() if f.kind == "unresolved-future"]
        assert len(finds) == 1 and "test_torch_sanitizer.py" in finds[0].site
        kept._set(2)
        assert [f for f in san.check() if f.kind == "unresolved-future"] == []


def test_dropped_future_not_reported():
    from deeplearning4j_tpu_torch.serving.engine import InferenceFuture

    with Sanitizer(scope_prefixes=HERE) as san:
        InferenceFuture()
        assert [f for f in san.check() if f.kind == "unresolved-future"] == []


def _tiny_charnn():
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(text_generation_lstm(11, hidden=8, seq_len=4), device="cpu")
    net.init(torch.Generator().manual_seed(3))
    return net


def test_serving_engine_burst_is_clean_under_the_sanitizer(graftsan):
    """A registry and engine built and served under the sanitizer: every
    submitted future tracked and resolved, the engine's locks recorded, no
    inversion, no leaked thread; the answers equal the plain forward."""
    from deeplearning4j_tpu_torch.serving import ModelRegistry

    net = _tiny_charnn()
    rs = np.random.RandomState(0)
    reqs = [np.eye(11, dtype=np.float32)[rs.randint(0, 11, size=(2, int(rs.randint(1, 5))))]
            for _ in range(12)]
    registry = ModelRegistry()
    try:
        engine = registry.register("charnn", net, input_spec=(4, 11), max_batch_size=8,
                                   seq_buckets=(2, 4), device="cpu")
        outs = [f.get(timeout=60) for f in [engine.submit(x, batched=True) for x in reqs]]
    finally:
        registry.stop()
    assert len(graftsan._futures) >= len(reqs)
    assert graftsan.report()["locks"], "the engine's locks were not recorded"
    for x, y in zip(reqs, outs):
        want = net.output(x)
        np.testing.assert_allclose(y, want.numpy() if torch.is_tensor(want) else want,
                                   atol=1e-6)


def test_engine_future_left_unresolved_is_reported():
    """Each future the engine hands out and never resolves would block its
    waiter: the two left pending are reported, the resolved one is not."""
    from deeplearning4j_tpu_torch.serving.engine import InferenceFuture

    with Sanitizer(scope_prefixes=HERE) as san:
        pending = [InferenceFuture() for _ in range(3)]
        pending[0]._set(0)
        finds = [f for f in san.check() if f.kind == "unresolved-future"]
        assert len(finds) == 2
        for f in pending[1:]:
            f._set_error(RuntimeError("stopped"))


# ----------------------------------------------------------------------
# report / merge (the lint --san-report input)
# ----------------------------------------------------------------------

def test_dump_roundtrip(tmp_path):
    with Sanitizer(scope_prefixes=HERE) as san:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        path = san.dump(tmp_path / "san.json")
    doc = json.loads((tmp_path / "san.json").read_text())
    assert path == tmp_path / "san.json"
    assert doc["version"] == 1 and len(doc["lock_order_edges"]) == 1
    assert doc["findings"] == [] and set(doc["locks"].values()) == {"Lock"}


def test_merge_accumulates_counts_and_findings():
    with Sanitizer(scope_prefixes=HERE) as san:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        rep = san.report()
    total = {}
    merge_report(total, rep)
    merge_report(total, rep)
    assert total["lock_order_edges"][0]["count"] == 2
    merge_report(total, {"lock_order_edges": [{"from": "x.py:1", "to": "y.py:2", "count": 3}],
                         "findings": [{"kind": "leaked-thread", "message": "m", "site": ""}]})
    assert len(total["lock_order_edges"]) == 2 and len(total["findings"]) == 1


def test_report_matches_the_jax_sanitizers_shape():
    """Both packages' sanitizers write one report format, so either's
    dump feeds either CLI's ``lint --san-report``."""
    with Sanitizer(scope_prefixes=HERE) as san:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        mine = san.report()
    with jax_sanitizer.Sanitizer(scope_prefixes=HERE) as jsan:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        theirs = jsan.report()
    assert set(mine) == set(theirs)
    assert [set(e) for e in mine["lock_order_edges"]] == \
        [set(e) for e in theirs["lock_order_edges"]]
