"""Model worker: registration, heartbeats, streaming generation
(counterpart of `faithdiff_tpu/serving/worker.py`).

Registers with the controller, heartbeats every
`WORKER_HEART_BEAT_INTERVAL` seconds (re-registering after an expiry),
serves `/worker_get_status` and `/worker_generate_stream` (one
`json + b"\0"` chunk a line) under a concurrency limit. The
`generate_fn(params) -> Iterator[str]` is injected: `main` serves the
CaptionAgent of a converted checkpoint on the card, an uploaded PNG or
JPEG (base64 in `image`, decoded by `utils/png.decode_image`) captioned with the
request's `prompt` as the question; tests use stubs.

    python -m faithdiff_tpu_torch.serving.worker --controller URL \
        --captioner_dir C [--load_4bit] [--port P] [--limit_concurrency 5] \
        [--device cpu]
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterator, List, Optional

from .controller import WORKER_HEART_BEAT_INTERVAL


class ModelWorker:
    def __init__(
        self,
        controller_addr: str,
        worker_addr: str,
        model_names: List[str],
        generate_fn: Callable[[dict], Iterator[str]],
        limit_concurrency: int = 5,
        register: bool = True,
    ):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:6]
        self.model_names = model_names
        self.generate_fn = generate_fn
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.queue_length = 0
        self.lock = threading.Lock()
        self._stop = threading.Event()
        if register:
            self.register_to_controller()
            self._hb = threading.Thread(
                target=self._heartbeat_loop, daemon=True)
            self._hb.start()

    def status(self) -> dict:
        return {
            "model_names": self.model_names,
            "speed": 1.0,
            "queue_length": self.queue_length,
        }

    def _post(self, path: str, payload: dict) -> Optional[dict]:
        try:
            req = urllib.request.Request(
                self.controller_addr + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def register_to_controller(self):
        self._post("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })

    def _heartbeat_loop(self):
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            ok = self._post("/receive_heart_beat", {
                "worker_name": self.worker_addr,
                "queue_length": self.queue_length,
            })
            if ok is not None and not ok.get("exist", False):
                self.register_to_controller()  # re-register after expiry

    def generate_stream(self, params: dict) -> Iterator[bytes]:
        with self.lock:
            self.queue_length += 1
        acquired = self.semaphore.acquire(timeout=60)
        try:
            if not acquired:
                yield json.dumps({"text": "", "error_code": 3}).encode() + b"\0"
                return
            for text in self.generate_fn(params):
                yield json.dumps(
                    {"text": text, "error_code": 0}).encode() + b"\0"
        except Exception as e:  # the request's error sentinel
            yield json.dumps(
                {"text": "", "error_code": 1,
                 "text_error": str(e)}).encode() + b"\0"
        finally:
            if acquired:
                self.semaphore.release()
            with self.lock:
                self.queue_length -= 1

    def stop(self):
        self._stop.set()


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/worker_get_status":
                data = json.dumps(worker.status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(body):
                    self.wfile.write(chunk + b"\n")
                    self.wfile.flush()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(worker: ModelWorker, host: str = "127.0.0.1",
          port: int = 40000) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def main(argv=None):
    """Serve a converted captioner checkpoint behind the controller: the
    JAX worker's flags (int8 by default, `--load_4bit` for NF4), plus
    `--device`."""
    import argparse
    import time as _time

    p = argparse.ArgumentParser("faithdiff-worker")
    p.add_argument("--controller", required=True,
                   help="controller URL, e.g. http://127.0.0.1:10000")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=40000)
    p.add_argument("--captioner_dir", required=True)
    p.add_argument("--model_name", default="llava")
    p.add_argument("--load_8bit", action="store_true", default=True)
    p.add_argument("--load_4bit", action="store_true")
    p.add_argument("--limit_concurrency", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="torch device the captioner runs on")
    args = p.parse_args(argv)

    from ..captioner.agent import CaptionAgent

    agent = CaptionAgent.from_checkpoint(
        args.captioner_dir, load_8bit=args.load_8bit and not args.load_4bit,
        load_4bit=args.load_4bit, device=args.device)

    def generate_fn(body: dict):
        import base64

        from ..utils.png import decode_image

        img = decode_image(base64.b64decode(body["image"]), "the uploaded image")
        kw = {}
        if body.get("prompt"):
            kw["question"] = body["prompt"]
        yield agent.caption(img, **kw)

    worker = ModelWorker(
        args.controller, f"http://{args.host}:{args.port}",
        [args.model_name], generate_fn,
        limit_concurrency=args.limit_concurrency)
    server = serve(worker, args.host, args.port)
    print(f"worker at http://{args.host}:{args.port} -> {args.controller}",
          flush=True)
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        worker.stop()
        server.shutdown()


if __name__ == "__main__":
    main()
