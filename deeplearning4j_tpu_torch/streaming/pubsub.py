"""NDArray pub/sub over TCP and a streaming training iterator.

The port of ``deeplearning4j_tpu/streaming/pubsub.py`` (dl4j-streaming's
Kafka publish/subscribe of NDArrays): a dependency-free length-prefixed
TCP broker, publishers and subscribers speaking ``streaming/codec.py``
frames, and a ``StreamingDataSetIterator`` that adapts a subscription
into the iterator contract so ``fit`` consumes an unbounded stream with
bounded buffering. The wire is the JAX package's, so a JAX publisher
feeds a port subscriber and the reverse.

Framing: 4-byte LE length | payload. A topic is selected once per
connection: a subscriber sends ``SUB <topic>\n``, a publisher
``PUB <topic>\n``; the broker fans every publish out to all matching
subscribers through drop-oldest per-subscriber bounded outboxes (a slow
consumer never stalls the topic). Drops are counted on the broker
(``dropped_total()``) and the subscriber (``dropped``), and with telemetry
on into ``stream_dropped_total{site=broker|subscriber}``
(``telemetry/registry.py``).
"""

from __future__ import annotations

import collections
import queue
import socket
import struct
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.streaming import codec


def _dropped_counter():
    return _tm.get_registry().counter(
        "stream_dropped_total",
        "payloads dropped oldest-first by a bounded streaming queue, "
        "labeled by site (broker = a slow subscriber's outbox overflowed; "
        "subscriber = the consumer fell behind its own receive queue)")


def _send_frame(sock, payload: bytes):
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock):
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (n,) = struct.unpack("<I", head)
    return _recv_exact(sock, n)


class _Outbox:
    """One subscriber's bounded send queue + writer thread.

    The broker used to ``sendall`` synchronously inside ``_fanout``: one
    subscriber whose TCP buffer filled (a trainer busy in a long
    dispatch) stalled EVERY publish to the topic — the unbounded-blocking
    analog of unbounded memory growth. Now each publish lands in a
    bounded per-subscriber deque (drop-OLDEST on overflow, counted
    ``stream_dropped_total{site=broker}`` — Kafka retention semantics,
    not backpressure) and a writer thread drains it; the socket write
    happens OUTSIDE the lock, so a wedged subscriber costs only its own
    queue."""

    def __init__(self, sock, capacity):
        self.sock = sock
        self.capacity = int(capacity)
        self.dropped = 0
        self._buf = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._m_dropped = _dropped_counter()
        self._reg = _tm.get_registry()
        self._t = threading.Thread(target=self._writer, daemon=True)
        self._t.start()

    def put(self, payload):
        with self._cv:
            if self._closed:
                return False
            if len(self._buf) >= self.capacity:
                self._buf.popleft()  # drop oldest: fresh data wins
                self.dropped += 1
                if self._reg.enabled:
                    self._m_dropped.inc(site="broker")
            self._buf.append(payload)
            self._cv.notify()
        return True

    def _writer(self):
        while True:
            with self._cv:
                while not self._buf and not self._closed:
                    self._cv.wait()
                if not self._buf and self._closed:
                    return
                payload = self._buf.popleft()
            try:
                # outside the lock: a slow socket blocks only this writer
                _send_frame(self.sock, payload)
            except OSError:
                self.close()
                return

    @property
    def closed(self):
        with self._cv:
            return self._closed

    def close(self):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass


class StreamingBroker:
    """In-process topic broker (the Kafka stand-in)."""

    def __init__(self, host="127.0.0.1", port=0, subscriber_buffer=1024):
        self.host = host
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self.subscriber_buffer = subscriber_buffer
        self._subs = collections.defaultdict(list)  # topic -> [_Outbox]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    def start(self):
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        with self._lock:  # _threads is shared with the accept thread
            self._threads.append(t)
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            # prune finished connection threads so a long-lived broker does
            # not accumulate one entry per historical connection
            with self._lock:  # start() appends from the caller thread
                self._threads = [th for th in self._threads if th.is_alive()]
                self._threads.append(t)

    def _serve(self, conn):
        keep_open = False
        try:
            line = b""
            while not line.endswith(b"\n"):
                ch = conn.recv(1)
                if not ch:
                    return
                line += ch
            parts = line.decode(errors="replace").strip().split(" ", 1)
            if len(parts) != 2 or parts[0] not in ("SUB", "PUB"):
                return  # unknown/garbage handshake: drop the connection
            mode, topic = parts
            if mode == "SUB":
                # the outbox's writer thread owns the socket from here —
                # its queue serializes frames, so concurrent publishers
                # can never interleave bytes inside a length-prefixed
                # frame (the role the per-socket send locks used to play)
                with self._lock:
                    self._subs[topic].append(
                        _Outbox(conn, self.subscriber_buffer))
                keep_open = True  # broker pushes to it; ownership transferred
                return
            while True:
                payload = _recv_frame(conn)
                if payload is None:
                    return
                self._fanout(topic, payload)
        except OSError:
            pass
        finally:
            if not keep_open:
                try:
                    conn.close()
                except OSError:
                    pass

    def _fanout(self, topic, payload):
        with self._lock:
            boxes = list(self._subs[topic])
        dead = [b for b in boxes if not b.put(payload)]
        if dead:
            with self._lock:
                for b in dead:
                    if b in self._subs[topic]:
                        self._subs[topic].remove(b)

    def dropped_total(self):
        """Broker-side drops across all subscriber outboxes (also counted
        into ``stream_dropped_total{site=broker}``)."""
        with self._lock:
            boxes = [b for subs in self._subs.values() for b in subs]
        return sum(b.dropped for b in boxes)

    def close(self):
        self._stop.set()
        self._srv.close()
        with self._lock:
            boxes = [b for subs in self._subs.values() for b in subs]
            self._subs.clear()
        for b in boxes:
            b.close()


class NDArrayPublisher:
    """Publish arrays/datasets to a topic (NDArrayKafkaClient publish role)."""

    def __init__(self, topic, host="127.0.0.1", port=None):
        self.sock = socket.create_connection((host, port))
        self.sock.sendall(f"PUB {topic}\n".encode())

    def publish(self, array):
        _send_frame(self.sock, codec.encode_ndarray(array))

    def publish_dataset(self, features, labels, ts=None):
        """``ts`` defaults to NOW — every dataset payload carries its
        publish time, so a bounded-staleness consumer can age it from
        the source (pass an older ts to model upstream delay)."""
        ts = time.time() if ts is None else float(ts)
        _send_frame(self.sock, codec.encode_dataset(features, labels,
                                                    ts=ts))

    def close(self):
        self.sock.close()


class NDArraySubscriber:
    """Subscribe to a topic; received payloads land in a bounded queue
    (drop-oldest on overflow)."""

    def __init__(self, topic, host="127.0.0.1", port=None, buffer=1024):
        self.sock = socket.create_connection((host, port))
        self.sock.sendall(f"SUB {topic}\n".encode())
        self.queue = queue.Queue(maxsize=buffer)
        self.dropped = 0
        self._m_dropped = _dropped_counter()
        self._reg = _tm.get_registry()
        self._closed = threading.Event()
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t.start()

    def _pump(self):
        while not self._closed.is_set():
            try:
                payload = _recv_frame(self.sock)
            except OSError:
                payload = None
            if payload is None:
                self._closed.set()
                return
            item = (time.monotonic(), payload)  # enqueue time for aging
            while True:
                try:
                    self.queue.put_nowait(item)
                    break
                except queue.Full:
                    try:
                        self.queue.get_nowait()  # drop oldest
                        self.dropped += 1
                        if self._reg.enabled:
                            self._m_dropped.inc(site="subscriber")
                    except queue.Empty:
                        pass

    def receive(self, timeout=None):
        """Next payload decoded (ndarray or (features, labels))."""
        return self.receive_timed(timeout=timeout)[1]

    def receive_timed(self, timeout=None):
        """``(age_s, decoded, publish_ts)``: the decoded payload plus how
        stale it is. ``age_s`` is time spent waiting in this subscriber's
        queue, extended back to the PUBLISH timestamp when the payload
        carries one (codec ``ts``) — the bounded-staleness admission
        signal for continuous training. ``publish_ts`` is None for
        payloads without the header field."""
        t_enq, payload = self.queue.get(timeout=timeout)
        age = time.monotonic() - t_enq
        kind, header, _ = codec._unpack(payload)
        ts = header.get("ts")
        if ts is not None:
            # wall-clock spans processes (publisher may be another pid);
            # never let clock skew make a batch look fresher than its
            # queue residency says it is
            age = max(age, time.time() - float(ts))
        if kind == codec._KIND_DATASET:
            return age, codec.decode_dataset(payload), ts
        return age, codec.decode_ndarray(payload), ts

    def close(self):
        self._closed.set()
        self.sock.close()


class StreamingDataSetIterator:
    """Adapt a subscriber into the DataSetIterator contract: pulls
    (features, labels) payloads until ``num_batches`` arrive (or the stream
    closes), so ``net.fit`` can train from a live stream (the reference's
    Camel route -> Spark streaming -> fit pipeline, dl4j-streaming)."""

    def __init__(self, subscriber: NDArraySubscriber, num_batches=None,
                 timeout=30.0):
        self.sub = subscriber
        self.num_batches = num_batches
        self.timeout = timeout

    def __iter__(self):
        seen = 0
        while self.num_batches is None or seen < self.num_batches:
            try:
                item = self.sub.receive(timeout=self.timeout)
            except queue.Empty:
                return
            if not isinstance(item, tuple):
                raise ValueError("Stream carries bare ndarrays, not datasets")
            yield np.asarray(item[0]), np.asarray(item[1])
            seen += 1

    def reset(self):
        pass
