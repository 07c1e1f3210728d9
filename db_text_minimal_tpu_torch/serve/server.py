"""Batch REST model server over the PyTorch handler.

Counterpart of ``db_text_minimal_tpu/serve/server.py``: ``POST
/predictions/<model_name>[?mode=masks|masks_png|boxes]`` with raw image
bytes returns the handler's JSON; a micro-batching queue coalesces
concurrent requests of the same mode into one device call.

Usage::

    python -m db_text_minimal_tpu_torch.serve.server --model_path model.pth \
        --port 8080 [--model_name dbtext] [--device cuda] \
        [--infer_mode folded|int8|flax]

``--model_path`` takes a ``.pth`` or checkpoint (served in
``--infer_mode``) or a ``.pt2`` export (``cli.export``; it carries its own
forward, and ``--infer_mode`` is ignored).
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..cli.common import INFER_MODES
from .handler import DBTextDetectionHandler

MODES = ("boxes", "masks_png", "masks")


class _Batcher:
    """Coalesce concurrent requests into handler batches."""

    def __init__(self, handler: DBTextDetectionHandler, max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        self.handler = handler
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, body: bytes, mode: str = "masks"):
        done = threading.Event()
        slot: dict = {}
        self.q.put((body, mode, done, slot))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _loop(self):
        while True:
            items = [self.q.get()]
            try:
                while len(items) < self.max_batch:
                    nxt = self.q.get(timeout=self.max_wait)
                    if nxt[1] != items[0][1]:   # one response mode per batch
                        self.q.put(nxt)
                        break
                    items.append(nxt)
            except queue.Empty:
                pass
            request = [{"body": body} for body, _, _, _ in items]
            try:
                results = self.handler.handle(request, mode=items[0][1])
                for (_, _, done, slot), result in zip(items, results):
                    slot["result"] = result
                    done.set()
            except Exception as e:   # report to every waiting request
                logging.getLogger(__name__).exception("batch failed")
                for _, _, done, slot in items:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    done.set()


def make_server(model_path: str, port: int = 8080,
                model_name: str = "dbtext", handler=None,
                max_batch: int = 8, device="cuda",
                infer_mode: str = "folded") -> ThreadingHTTPServer:
    service = handler or DBTextDetectionHandler(
        model_path, infer_mode=infer_mode, device=device)
    if not service.initialized:
        service.initialize()
    batcher = _Batcher(service, max_batch=max_batch)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path.rstrip("/") != f"/predictions/{model_name}":
                self.send_error(404, "unknown model")
                return
            mode = urllib.parse.parse_qs(query).get("mode", ["masks"])[0]
            if mode not in MODES:
                mode = "masks"
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                result = batcher.submit(body, mode=mode)
            except RuntimeError as e:
                self.send_error(500, str(e))
                return
            payload = json.dumps(result).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/ping":
                payload = b'{"status": "Healthy"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self.send_error(404)

        def log_message(self, *args):
            pass

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True,
                        help="a .pth or checkpoint, or a .pt2 export")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--model_name", type=str, default="dbtext")
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--infer_mode", type=str, default="folded",
                        choices=INFER_MODES,
                        help="the forward: BN-folded (default), int8 with "
                             "dynamic scales, or the plain module (flax)")
    args = parser.parse_args(argv)
    server = make_server(args.model_path, args.port, args.model_name,
                         max_batch=args.max_batch, device=args.device,
                         infer_mode=args.infer_mode)
    print(f"serving {args.model_name} on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
