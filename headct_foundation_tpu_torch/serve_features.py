"""Embedding server: NIfTI bytes in, CLS embeddings out.

Port of the JAX package's ``tools/serve_features.py`` onto the PyTorch
``FeatureExtractor``:

* the model is built once at startup, and a warm-up forward builds the CUDA
  kernel before the server accepts traffic;
* request handler threads decode the body in memory and run the on-device
  preprocessing;
* one dispatcher thread MICRO-BATCHES concurrent requests into one device
  forward. Batches are not padded to ``max_batch``: eager PyTorch runs any
  batch size without a recompile.

Endpoints:
  GET  /healthz       -> {"ok": true, "device": ..., "hidden": ...}
  POST /embed         -> body: .nii.gz or .nii bytes
                         response: {"embedding": [hidden floats],
                                    "ms": total, "batched_with": n}

Usage:
  python -m headct_foundation_tpu_torch.serve_features --device cuda --port 8476
  curl -s --data-binary @scan.nii.gz localhost:8476/embed | jq .embedding
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch


class MicroBatcher:
    """Coalesce concurrent single-volume requests into one device forward.

    ``submit`` blocks the calling handler thread until its embedding is
    ready. The dispatcher waits up to ``window_ms`` after the first queued
    request for stragglers (at most ``max_batch``), stacks them, runs one
    forward and fans the CLS rows back out."""

    def __init__(self, extractor, max_batch: int = 8, window_ms: float = 5.0):
        self.extractor = extractor
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._lock = threading.Lock()
        self._queue = []  # [(volume, slot)]
        self._wakeup = threading.Event()
        self._stop = False
        self.batches = 0
        self.requests = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="headct-batcher")
        self._thread.start()

    def submit(self, volume: torch.Tensor):
        slot = {"event": threading.Event()}
        with self._lock:
            self._queue.append((volume, slot))
        self._wakeup.set()
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["embedding"], slot["batched_with"]

    def close(self):
        self._stop = True
        self._wakeup.set()
        self._thread.join(timeout=5)

    def _run(self):
        while not self._stop:
            self._wakeup.wait()
            if self._stop:
                return
            # linger for stragglers: batch whatever arrives inside the window
            deadline = time.monotonic() + self.window_s
            while time.monotonic() < deadline:
                with self._lock:
                    if len(self._queue) >= self.max_batch:
                        break
                time.sleep(self.window_s / 5)
            with self._lock:
                batch, self._queue = self._queue[: self.max_batch], self._queue[self.max_batch:]
                if not self._queue:
                    self._wakeup.clear()
            if not batch:
                continue
            try:
                cls = self.extractor.cls_embedding(torch.stack([v for v, _ in batch]))
                n = len(batch)
                self.batches += 1
                self.requests += n
                for i, (_, slot) in enumerate(batch):
                    slot["embedding"] = cls[i]
                    slot["batched_with"] = n
                    slot["event"].set()
            except Exception as e:  # surface to every waiting handler
                for _, slot in batch:
                    slot["error"] = e
                    slot["event"].set()


def make_handler(extractor, batcher):
    device = str(extractor.device)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet per-request stderr spam
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "device": device,
                    "hidden": int(extractor.model.hidden_size),
                    "batches": batcher.batches,
                    "requests": batcher.requests,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/embed":
                self._json(404, {"error": "unknown path"})
                return
            t0 = time.monotonic()
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                vol = extractor.preprocess(self.rfile.read(length))
                emb, batched_with = batcher.submit(vol)
            except Exception as e:  # a bad request must not wedge the server
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {
                "embedding": [float(x) for x in emb],
                "ms": round((time.monotonic() - t0) * 1e3, 1),
                "batched_with": batched_with,
            })

    return Handler


def build_server(extractor, host: str = "127.0.0.1", port: int = 8476,
                 max_batch: int = 8, window_ms: float = 5.0):
    """Returns (ThreadingHTTPServer, MicroBatcher): the caller runs
    serve_forever (the CLI) or drives it from a thread (tests)."""
    batcher = MicroBatcher(extractor, max_batch=max_batch, window_ms=window_ms)
    server = ThreadingHTTPServer((host, port), make_handler(extractor, batcher))
    return server, batcher


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None,
                    help="reference .pt or a pickle of either package to load (seeded "
                         "random init if omitted)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--img-size", type=int, default=96)
    ap.add_argument("--in-chans", type=int, default=3)
    args = ap.parse_args(argv)

    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    extractor = FeatureExtractor(checkpoint_path=args.checkpoint, img_size=args.img_size,
                                 in_chans=args.in_chans, device=args.device)
    # build the kernel and warm the allocator before accepting traffic
    extractor(torch.zeros((args.max_batch, args.in_chans) + (args.img_size,) * 3))
    server, batcher = build_server(extractor, args.host, args.port,
                                   args.max_batch, args.window_ms)
    print(f"serving on {args.host}:{args.port} "
          f"(device={extractor.device}, max_batch={args.max_batch})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
