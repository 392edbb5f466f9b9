"""HTTP model server over an exported artifact (counterpart of
``examples/serving/serve.py``; stdlib HTTP, torch and this package).

    python -m unet3d_tpu_torch.scripts.serve --artifact model.u3dexp --port 8642

    GET  /health        -> JSON: {"status": "ok", **the artifact's header}
    POST /predict       -> body: one .npy (np.save) array in the artifact's
                           entry layout (channel-first (B, C, D, H, W) by
                           default; (B, D, H, W, C) for entry_layout "ndhwc",
                           see GET /health), float32; response: one .npy
                           array, same layout

Codes: 400 for a body that is not a .npy array or an array of the wrong
shape or dtype, 404 for any other path, 413 for a body over
``--max_body_mb``, 500 for a failure on the device. One lock serialises the
requests on the device. The artifact (``unet3d-torch-export``) is loaded
onto the first CUDA GPU (``load_exported``, which raises without one;
``build_server`` takes ``device="cpu"``), and its graph launches the port's
hand kernels there, so the serving host needs torch and this package, not
the model code, the config or the checkpoint. A dynamic-batch artifact
serves any batch size the client posts. Client example:

    import io, urllib.request
    import numpy as np
    buf = io.BytesIO(); np.save(buf, x)               # x: (B, C, D, H, W) f32
    req = urllib.request.Request("http://host:8642/predict", buf.getvalue())
    out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from unet3d_tpu_torch.predict.export import load_exported


def make_handler(served, lock: threading.Lock, max_body_bytes: int = 1 << 30):
    class Handler(BaseHTTPRequestHandler):
        def _respond(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, error) -> None:
            message = error if isinstance(error, str) else f"{type(error).__name__}: {error}"
            self._respond(code, json.dumps({"error": message}).encode(), "application/json")

        def do_GET(self):
            if self.path != "/health":
                return self._error(404, "not found")
            body = json.dumps({"status": "ok", **served.metadata}).encode()
            self._respond(200, body, "application/json")

        def do_POST(self):
            if self.path != "/predict":
                return self._error(404, "not found")
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > max_body_bytes:
                    return self._error(413, f"request body {n} bytes exceeds limit "
                                            f"{max_body_bytes}")
                x = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
            except Exception as error:  # malformed body: the client's fault
                return self._error(400, error)
            try:
                # one request at a time on the device
                with lock:
                    out = served(x).cpu().numpy()
            except (ValueError, TypeError) as error:  # wrong shape or dtype
                return self._error(400, error)
            except Exception as error:  # device, memory: the server's fault
                logging.exception("predict failed")
                return self._error(500, error)
            buf = io.BytesIO()
            np.save(buf, out)
            self._respond(200, buf.getvalue(), "application/octet-stream")

        def log_message(self, fmt, *args):
            logging.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def build_server(artifact: str, host: str = "127.0.0.1", port: int = 8642,
                 max_body_bytes: int = 1 << 30, device=None) -> ThreadingHTTPServer:
    """Load the artifact onto ``device`` (default: the first CUDA GPU) and
    return a ready server (``serve_forever`` runs it)."""
    served = load_exported(artifact, device)
    logging.info("Loaded %s on %s: in=%s platforms=%s", artifact, served.device,
                 served.metadata.get("in_avals"), served.metadata.get("platforms"))
    return ThreadingHTTPServer((host, port), make_handler(served, threading.Lock(),
                                                          max_body_bytes=max_body_bytes))


def main(args=None, device=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--artifact", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8642)
    parser.add_argument("--max_body_mb", type=int, default=1024,
                        help="Reject /predict bodies larger than this (413).")
    namespace = parser.parse_args(args)
    server = build_server(namespace.artifact, namespace.host, namespace.port,
                          max_body_bytes=namespace.max_body_mb << 20, device=device)
    logging.info("Serving on %s:%d", *server.server_address)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
