"""Nearest-neighbor REST server + client.

Reference analog: deeplearning4j-nearestneighbors-parent/
deeplearning4j-nearestneighbor-server (Play-based REST endpoint /knn) and
nearestneighbor-client in the reference. Here: stdlib http.server JSON
endpoint — POST /knn {"vector": [...], "k": N} -> {"indices": [...],
"distances": [...]}.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree


class NearestNeighborServer:
    def __init__(self, points, *, port=0, distance="euclidean"):
        self.tree = VPTree(points, distance=distance)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                if self.path != "/knn":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                idx, dist = server.tree.knn(np.asarray(req["vector"], np.float64),
                                            int(req.get("k", 1)))
                body = json.dumps({"indices": list(map(int, idx)),
                                   "distances": list(map(float, dist))}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


class NearestNeighborClient:
    def __init__(self, host="127.0.0.1", port=8080):
        self.base = f"http://{host}:{port}"

    def knn(self, vector, k=1):
        import urllib.request
        req = urllib.request.Request(
            self.base + "/knn",
            data=json.dumps({"vector": list(map(float, vector)), "k": k}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            out = json.loads(resp.read())
        return out["indices"], out["distances"]
