"""FancyBlockingQueue binding: one queue, N consumers, each message delivered
to every registered consumer exactly once.

Reference analog: optimize/solvers/accumulation/FancyBlockingQueue.java (the
gradient fan-out structure inside EncodedGradientsAccumulator, SURVEY.md §2.1
/ §5). The queue itself is native C++ (native/src/fbq.cc, std::mutex/condvar);
Python objects ride as int64 tokens mapped back on this side. A pure-Python
fallback (per-consumer deques under one lock) engages without the native lib.
"""

from __future__ import annotations

import itertools
import threading


class FancyBlockingQueue:
    def __init__(self, capacity: int = 256):
        import collections
        self.capacity = capacity
        self._tokens = {}
        self._tok_order = collections.deque()
        self._counter = itertools.count(1)
        self._tok_lock = threading.Lock()
        self._n_consumers_cache = 0
        try:
            from deeplearning4j_tpu_torch import native as _native
            self._lib = _native.lib()
            self._h = self._lib.dl4j_fbq_create(capacity)
            self._native = True
        except RuntimeError:
            self._native = False
            self._lock = threading.Condition()
            self._buf = []
            self._head_seq = 0
            self._cursors = []
            self._closed = False

    # -- native-token plumbing ------------------------------------------------
    # Tokens are garbage-collected by age, not refcount: the native queue's
    # backpressure bounds any consumer's lag to `capacity`, so a token older
    # than 2*capacity publishes can no longer be pending anywhere. This is
    # race-free against concurrent register_consumer (a refcount of "expected
    # deliveries" is not — registration and put can interleave either way).
    def _store(self, obj) -> int:
        with self._tok_lock:
            tok = next(self._counter)
            self._tokens[tok] = obj
            self._tok_order.append(tok)
            while len(self._tok_order) > 2 * self.capacity + 8:
                old = self._tok_order.popleft()
                self._tokens.pop(old, None)
            return tok

    def _fetch(self, tok: int):
        with self._tok_lock:
            return self._tokens.get(tok)

    # -- API ------------------------------------------------------------------
    def register_consumer(self) -> int:
        if self._native:
            cid = int(self._lib.dl4j_fbq_register(self._h))
            with self._tok_lock:  # counter read by token refcounting
                self._n_consumers_cache += 1
            return cid
        with self._lock:
            self._cursors.append(self._head_seq + len(self._buf))
            self._n_consumers_cache += 1
            return len(self._cursors) - 1

    @property
    def n_consumers(self) -> int:
        if self._native:
            # tracked Python-side for token refcounting
            return self._n_consumers_cache
        return len(self._cursors)

    def put(self, obj, timeout: float | None = None) -> bool:
        if obj is None:
            raise ValueError("FancyBlockingQueue cannot carry None")
        if self._native:
            tok = self._store(obj)
            r = self._lib.dl4j_fbq_put(
                self._h, tok, -1 if timeout is None else int(timeout * 1000))
            if r != 0:
                # full rollback: leaving the failed token in _tok_order would
                # make the age-out window count put *attempts*, letting
                # repeated failed puts evict tokens of messages still queued
                with self._tok_lock:
                    self._tokens.pop(tok, None)
                    try:
                        self._tok_order.remove(tok)
                    except ValueError:
                        pass
            return r == 0
        with self._lock:
            while not self._closed and len(self._buf) >= self.capacity:
                if not self._lock.wait(timeout):
                    return False
            if self._closed:
                return False
            self._buf.append(obj)
            self._lock.notify_all()
            return True

    def poll(self, consumer: int, timeout: float | None = None):
        """Next unseen message for ``consumer``; None if closed+drained or
        timed out."""
        if self._native:
            import ctypes
            while True:
                out = ctypes.c_int64()
                r = self._lib.dl4j_fbq_poll(
                    self._h, consumer,
                    -1 if timeout is None else int(timeout * 1000),
                    ctypes.byref(out))
                if r != 0:
                    return None
                obj = self._fetch(int(out.value))
                if obj is not None:  # None = token aged out (can't occur
                    return obj       # within the capacity bound; re-poll)
        with self._lock:
            while True:
                idx = self._cursors[consumer] - self._head_seq
                if idx < len(self._buf):
                    obj = self._buf[idx]
                    self._cursors[consumer] += 1
                    m = min(self._cursors) - self._head_seq
                    if m > 0:
                        del self._buf[:m]
                        self._head_seq += m
                        self._lock.notify_all()
                    return obj
                if self._closed:
                    return None
                if not self._lock.wait(timeout):
                    return None

    def pending(self, consumer: int) -> int:
        if self._native:
            return int(self._lib.dl4j_fbq_pending(self._h, consumer))
        with self._lock:
            return self._head_seq + len(self._buf) - self._cursors[consumer]

    def close(self) -> None:
        if self._native:
            self._lib.dl4j_fbq_close(self._h)
        else:
            with self._lock:
                self._closed = True
                self._lock.notify_all()

    def __del__(self):
        try:
            if getattr(self, "_native", False):
                self._lib.dl4j_fbq_close(self._h)
                self._lib.dl4j_fbq_destroy(self._h)
        except Exception:
            pass
