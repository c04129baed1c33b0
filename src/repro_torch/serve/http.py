"""Minimal JSON-over-HTTP front-end for `EmbeddingServer`.

Port of `repro/serve/http.py`: the same endpoints, bodies and status codes.
Stdlib only (`http.server`): a wire-protocol reference and a testable
end-to-end path, not a production web stack.  Endpoints:

    POST /transform   {"rows": [[...], ...]}        (one or more queries)
                   -> {"embedding": [[...], ...], "n": int}
                      400 on malformed input, 504 past the deadline,
                      500 for compute errors (error isolation: the server
                      keeps serving)
    GET  /healthz  -> {"ok": true, "n_train": int, "dim": int}
    GET  /stats    -> EmbeddingServer.stats() (latency percentiles,
                      batch counters, bucket cache keys)

Run it from an artifact (`Embedding.save`, of either package):

    python -m repro_torch.serve.http --artifact model.npz --port 8808

It serves on the current CUDA device unless `--device` names another (e.g.
``--device cpu``); without CUDA and without `--device` it exits with an
error.  `--telemetry DIR` writes one request record a request to
`DIR/run.jsonl` and the batches' spans to `DIR/trace.json` (on shutdown).
The handler threads (`ThreadingHTTPServer`) all funnel into ONE
`EmbeddingServer`, so concurrent HTTP clients get micro-batched exactly
like in-process `submit()` callers.  SIGTERM/SIGINT shut down gracefully:
stop accepting, drain the queue, then exit.  `make_http_server` builds the
front-end without running it, for a caller that runs and stops it itself.
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .server import EmbeddingServer


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-torch-serve/1"
    # the EmbeddingServer is attached to the HTTP server object
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        es: EmbeddingServer = self.server.embedding_server
        if self.path == "/healthz":
            emb = es.embedding
            self._reply(200, {
                "ok": True,
                "n_train": int(emb.embedding_.shape[0]),
                "dim": int(emb._Y_train.shape[1]),
                "kind": emb.spec.kind,
            })
        elif self.path == "/stats":
            self._reply(200, es.stats())
        else:
            self._reply(404, {"error": f"no such endpoint: {self.path}"})

    def do_POST(self):
        if self.path != "/transform":
            self._reply(404, {"error": f"no such endpoint: {self.path}"})
            return
        es: EmbeddingServer = self.server.embedding_server
        try:
            length = int(self.headers.get("Content-Length", 0))
            obj = json.loads(self.rfile.read(length))
            rows = np.asarray(obj["rows"], dtype=np.float32)
            if rows.ndim != 2:
                raise ValueError(f"rows must be 2-d, got shape {rows.shape}")
        except Exception as e:
            self._reply(400, {"error": f"bad request: {e}"})
            return
        try:
            X = es.transform(rows)
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {"embedding": np.asarray(X).tolist(),
                          "n": int(np.asarray(X).shape[0])})


def make_http_server(embedding_server: EmbeddingServer, *,
                     host: str = "127.0.0.1", port: int = 8808,
                     verbose: bool = False) -> ThreadingHTTPServer:
    """The HTTP front-end bound to (host, port) (port 0: any free one,
    `server_address` says which), not yet serving."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.embedding_server = embedding_server
    httpd.verbose = verbose
    return httpd


def serve_http(embedding_server: EmbeddingServer, *, host: str = "127.0.0.1",
               port: int = 8808, verbose: bool = False) -> None:
    """Run the HTTP front-end until SIGINT/SIGTERM, then drain and close
    the embedding server."""
    httpd = make_http_server(embedding_server, host=host, port=port,
                             verbose=verbose)

    def _stop(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _stop)
        except ValueError:
            pass                      # not the main thread (tests)
    host, port = httpd.server_address[:2]
    print(f"repro_torch.serve.http: listening on http://{host}:{port} "
          f"(POST /transform, GET /healthz, GET /stats)", flush=True)
    try:
        httpd.serve_forever(poll_interval=0.1)
    finally:
        httpd.server_close()
        embedding_server.close(drain=True)
        print("repro_torch.serve.http: drained and closed", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve transform() over HTTP from a saved artifact")
    ap.add_argument("--artifact", required=True,
                    help="path written by Embedding.save()")
    ap.add_argument("--y-train", default=None,
                    help="training Y .npy for train='ref' artifacts")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8808)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request queue deadline (default: none)")
    ap.add_argument("--warmup", type=int, nargs="*", default=None,
                    help="batch sizes to run once before serving (default: "
                         "every pow2 bucket up to --max-batch; pass sizes "
                         "to narrow, or --no-warmup to skip)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the current "
                         "CUDA device; 'cpu' for the CPU)")
    ap.add_argument("--telemetry", default=None,
                    help="telemetry output directory (request JSONL)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    Y_train = None if args.y_train is None else np.load(args.y_train)
    es = EmbeddingServer.from_artifact(
        args.artifact, Y_train=Y_train, device=args.device,
        max_batch=args.max_batch, max_delay_s=args.max_delay_ms / 1e3,
        timeout_s=args.timeout_s, telemetry=args.telemetry)
    if not args.no_warmup:
        keys = es.warmup(args.warmup)
        print(f"repro_torch.serve.http: warmed {keys}", flush=True)
    serve_http(es, host=args.host, port=args.port, verbose=args.verbose)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
