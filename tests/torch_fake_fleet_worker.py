"""Fake fleet worker for the port's FleetSupervisor tests.

Speaks the port's fleet worker wire protocol (the ready line with the
bound port, ``/health``, ``/submit`` answering rows scaled by
``--scale``, ``/swap``, ``/shutdown``) with the standard library alone:
no torch, no jax and neither package, so supervisor lifecycle tests
(spawn, probe, SIGKILL, elastic respawn, hot-swap fan-out) cost
milliseconds a process instead of a torch import and a warm-up.

Usage: torch_fake_fleet_worker.py --worker-id w0 [--scale 2.0] [--sleep-ms N]
"""

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--worker-id", default="w0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--scale", type=float, default=2.0,
                   help="outputs = scale * rows (parity checks)")
    p.add_argument("--sleep-ms", type=float, default=0.0,
                   help="artificial per-request latency")
    # the real worker's flags arrive too when the supervisor builds the
    # default command; accept and ignore them
    args, _extra = p.parse_known_args(argv)
    stop = threading.Event()
    swaps = {"n": 0}

    class Handler(BaseHTTPRequestHandler):
        daemon_threads = True

        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/health"):
                self._json({"ok": True, "worker_id": args.worker_id,
                            "pid": os.getpid(), "fake": True})
            else:
                self._json({"error": "unknown"}, code=404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length) or b"{}")
            if self.path.startswith("/submit"):
                if args.sleep_ms:
                    time.sleep(args.sleep_ms / 1e3)
                rows = doc["rows"]
                outs = [[args.scale * v for v in row] for row in rows]
                self._json({"outputs": outs,
                            "worker_id": args.worker_id})
            elif self.path.startswith("/swap"):
                swaps["n"] += 1
                self._json({"ok": True, "worker_id": args.worker_id,
                            "swaps": swaps["n"],
                            "model_path": doc.get("model_path")})
            elif self.path.startswith("/shutdown"):
                self._json({"ok": True})
                stop.set()
            else:
                self._json({"error": "unknown"}, code=404)

    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    # the ready line the port's worker prints, with a warm aot block and no
    # nvcc build, so replacement_is_warm() holds for fake respawns
    print(json.dumps({
        "fleet_worker_ready": True, "worker_id": args.worker_id,
        "pid": os.getpid(), "port": httpd.server_address[1],
        "model": "fake", "buckets": [1],
        "aot": {"warmed": 1, "manifest_hits": 1, "manifest_misses": 0,
                "manifest": "attached"},
        "kernel_builds": {}}), flush=True)
    while not stop.wait(timeout=0.2):
        pass
    httpd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
