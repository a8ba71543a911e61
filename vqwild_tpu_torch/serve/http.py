"""Stdlib HTTP front-end for the query service (a copy of
vqwild_tpu/serve/http.py).

Endpoints (JSON unless noted):
  GET  /healthz         → {"ok": true, "gallery": N}
  POST /query/features  → body {"feature": [C floats], "k": 30?}
                          → {"results": [{video_id, label, retrieval_type,
                                          score, rank}, ...]}
  POST /query/clip      → body: npz bytes with arrays "y" [T,s,s] u8 and
                          "uv" [T,s/2,s/2,2] u8 (?k=30 query param)
                          → same response shape
  POST /query/moments   → body {"feature": [C floats], "k": 10?, "nms": 0.5?}
                          → {"results": [{video_id, start_sec, end_sec,
                                          score, rank}, ...]} (requires a
                          moment index; without one it answers 500)

ThreadingHTTPServer: each connection blocks in its own thread while the
micro-batcher coalesces concurrent requests into single device dispatches.
"""

from __future__ import annotations

import io
import json
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.serve.service import QueryService

log = get_logger("serve.http")

# exception classes that mean "the request body was malformed" → 400; anything
# else is a server bug → 500. Neither response carries repr(e) — exception
# messages can leak filesystem paths and internal config (full details go to
# the server log instead).
_BAD_REQUEST = (
    ValueError,  # json decode errors subclass this; also bad array payloads
    KeyError,  # missing "feature" / "y" / "uv"
    TypeError,  # wrong JSON types (e.g. feature: "abc")
    OSError,  # np.load on a non-npz body
    zipfile.BadZipFile,  # truncated/corrupt npz
)


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 drops the SYNs of concurrent clients
    # beyond it, and each dropped connect is retried ~1 s later
    request_queue_size = 128


def make_server(service: QueryService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log.info("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._send(200, {"ok": True, "gallery": service.index.n})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            try:
                if parsed.path == "/query/features":
                    req = json.loads(raw)
                    results = service.query_features(
                        np.asarray(req["feature"], np.float32), k=req.get("k")
                    )
                elif parsed.path == "/query/moments":
                    req = json.loads(raw)
                    results = service.query_moments(
                        np.asarray(req["feature"], np.float32),
                        k=int(req.get("k", 10)),
                        nms_threshold=float(req.get("nms", 0.5)),
                    )
                elif parsed.path == "/query/clip":
                    qs = parse_qs(parsed.query)
                    k = int(qs["k"][0]) if "k" in qs else None
                    with np.load(io.BytesIO(raw)) as z:
                        y, uv = z["y"], z["uv"]
                    results = service.query_clip(y, uv, k=k)
                else:
                    self._send(404, {"error": "not found"})
                    return
            except _BAD_REQUEST as e:
                # malformed payloads are the client's fault; report the error
                # class only — messages can embed paths/shapes/config
                log.warning("bad request on %s: %r", parsed.path, e)
                self._send(400, {"error": f"bad request: {type(e).__name__}"})
                return
            except Exception:
                log.exception("internal error on %s", parsed.path)
                self._send(500, {"error": "internal error"})
                return
            self._send(200, {"results": results})

    return _Server((host, port), Handler)
