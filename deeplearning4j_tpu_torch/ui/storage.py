"""Stats storage.

The port of ``deeplearning4j_tpu/ui/storage.py``, a copy: the module is
the standard library only, and each package's ``FileStatsStorage`` reads
the other's JSON lines.

Reference analog: deeplearning4j-core api/storage/StatsStorage.java +
StatsStorageRouter.java + impl/RemoteUIStatsStorageRouter.java (SURVEY.md
§2.4) and the MapDB/file-backed storages in the UI module. Implementations:
in-memory, JSON-lines file, HTTP POST router (remote ingestion, the
RemoteReceiverModule counterpart).
"""

from __future__ import annotations

import json
import os
import threading


class InMemoryStatsStorage:
    def __init__(self):
        self.records = []
        self._listeners = []
        self._lock = threading.RLock()

    def put_record(self, record: dict):
        with self._lock:
            self.records.append(record)
        for cb in self._listeners:
            cb(record)

    def get_records(self, session=None, type_=None):
        with self._lock:
            recs = [r for r in self.records if isinstance(r, dict)]
        if session is not None:
            recs = [r for r in recs if r.get("session") == session]
        if type_ is not None:
            recs = [r for r in recs if r.get("type") == type_]
        return recs

    def sessions(self):
        return sorted({r.get("session", "default") for r in self.records
                       if isinstance(r, dict)})

    def register_listener(self, cb):
        with self._lock:  # registration may race a publishing fit thread
            self._listeners.append(cb)


class FileStatsStorage(InMemoryStatsStorage):
    """JSON-lines persistence (reference analog: FileStatsStorage on MapDB)."""

    def __init__(self, path):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.records.append(json.loads(line))
        self._fh = open(path, "a")

    def put_record(self, record):
        line = json.dumps(record) + "\n"
        with self._lock:  # append + file write atomically, so lines can't interleave
            super().put_record(record)
            self._fh.write(line)
            self._fh.flush()

    def close(self):
        self._fh.close()


class RemoteStatsStorageRouter:
    """POST records to a remote UIServer (reference:
    RemoteUIStatsStorageRouter → RemoteReceiverModule).

    Asynchronous like the reference: records go on a bounded queue drained by
    a daemon thread, so a slow or dead UI server never blocks (or kills) the
    training loop. Failed posts are retried up to ``max_retries`` then dropped
    and counted in ``dropped``.
    """

    def __init__(self, url, *, queue_size=1024, max_retries=3, timeout=5.0):
        import queue
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout
        self.max_retries = max_retries
        self.dropped = 0
        self._stopping = False
        self._q = queue.Queue(maxsize=queue_size)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def put_record(self, record):
        import queue
        try:
            self._q.put_nowait(record)
        except queue.Full:
            self.dropped += 1

    def _post(self, record):
        import urllib.request
        req = urllib.request.Request(
            self.url, data=json.dumps(record).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()

    def _drain(self):
        import queue
        while True:
            try:
                record = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._stopping:
                    return
                continue
            try:
                if record is _SHUTDOWN:
                    return
                for attempt in range(self.max_retries):
                    try:
                        self._post(record)
                        break
                    except Exception:
                        if attempt == self.max_retries - 1:
                            self.dropped += 1
            finally:
                # queue.unfinished_tasks is the flush() barrier: put()
                # increments it atomically, so a record is "done" only after
                # its POST completes (or is dropped)
                self._q.task_done()

    def flush(self, timeout=10.0):
        """Block until the queue has drained (best-effort, for tests/shutdown)."""
        import time as _time
        deadline = _time.time() + timeout
        while self._q.unfinished_tasks and _time.time() < deadline:
            _time.sleep(0.01)

    def close(self):
        import queue
        self.flush()
        self._stopping = True  # drain thread exits even if the queue is jammed
        try:
            self._q.put_nowait(_SHUTDOWN)
        except queue.Full:
            pass
        self._thread.join(timeout=5)


_SHUTDOWN = object()
