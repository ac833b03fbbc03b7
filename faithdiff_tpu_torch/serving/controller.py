"""Serving controller: worker registry, heartbeats, dispatch, failover
(counterpart of `faithdiff_tpu/serving/controller.py`, which holds no
model; the port keeps its own copy).

Workers register and heartbeat (a worker silent for
`CONTROLLER_HEART_BEAT_EXPIRATION` seconds expires), requests dispatch by
LOTTERY (speed-weighted draws from a `numpy.random.Generator`) or
SHORTEST_QUEUE (queue length over speed), and generation proxies to the
chosen worker, failing over to the next on error. Standard library
`http.server` and threads; the routes:
  POST /register_worker     {worker_name, check_heart_beat, worker_status}
  POST /receive_heart_beat  {worker_name, queue_length}
  POST /list_models
  POST /get_worker_address  {model}
  POST /worker_generate_stream  (proxied; `json + b"\0"` chunks)

    python -m faithdiff_tpu_torch.serving.controller [--host H] [--port P] \
        [--dispatch lottery|shortest_queue]
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

# the reference's constants (LLaVA's `constants.py`)
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, daemon=True)
        self._sweeper.start()

    # ------------------------------------------------------------------
    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        if status is None:
            status = self._get_worker_status(name)
        if status is None:
            return False
        with self.lock:
            self.workers[name] = WorkerInfo(
                model_names=status["model_names"],
                speed=status.get("speed", 1.0),
                queue_length=status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time(),
            )
        return True

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            if name not in self.workers:
                return False
            self.workers[name].queue_length = queue_length
            self.workers[name].last_heart_beat = time.time()
            return True

    def remove_stale_workers(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self.lock:
            dead = [n for n, w in self.workers.items()
                    if w.check_heart_beat and w.last_heart_beat < expire]
            for n in dead:
                del self.workers[n]
        return dead

    def _sweep_loop(self):
        while not self._stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION):
            self.remove_stale_workers()

    def list_models(self) -> List[str]:
        with self.lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
        return sorted(names)

    def get_worker_address(self, model: str,
                           rng: Optional[np.random.Generator] = None) -> str:
        rng = rng or np.random.default_rng()
        with self.lock:
            candidates = [
                (n, w) for n, w in self.workers.items()
                if model in w.model_names
            ]
        if not candidates:
            return ""
        if self.dispatch_method == "lottery":
            speeds = np.asarray([w.speed for _, w in candidates], np.float32)
            if speeds.sum() <= 0:
                return ""
            idx = int(rng.choice(len(candidates), p=speeds / speeds.sum()))
            return candidates[idx][0]
        # shortest queue, normalised by speed
        qls = [w.queue_length / max(w.speed, 1e-6) for _, w in candidates]
        idx = int(np.argmin(qls))
        name, w = candidates[idx]
        with self.lock:
            if name in self.workers:
                self.workers[name].queue_length += 1
        return name

    def _get_worker_status(self, addr: str) -> Optional[dict]:
        try:
            req = urllib.request.Request(
                addr + "/worker_get_status", data=b"{}",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def generate_stream(self, params: dict):
        """Proxy a generation request to a worker of its model; a worker
        that fails is dropped and the next one tried; with none left, one
        error sentinel (error_code 2)."""
        model = params.get("model", "")
        tried = set()
        while True:
            addr = self.get_worker_address(model)
            if not addr or addr in tried:
                yield json.dumps(
                    {"text": "", "error_code": 2,
                     "text_error": "no available worker"}).encode() + b"\0"
                return
            tried.add(addr)
            try:
                req = urllib.request.Request(
                    addr + "/worker_generate_stream",
                    data=json.dumps(params).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    for chunk in iter(lambda: r.readline(), b""):
                        if chunk.strip():
                            yield chunk
                return
            except Exception:
                with self.lock:
                    self.workers.pop(addr, None)
                continue

    def stop(self):
        self._stop.set()


def _json_body(handler: BaseHTTPRequestHandler) -> dict:
    length = int(handler.headers.get("Content-Length", 0))
    raw = handler.rfile.read(length) if length else b"{}"
    return json.loads(raw or b"{}")


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            body = _json_body(self)
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    body["worker_name"], body.get("check_heart_beat", True),
                    body.get("worker_status"))
                self._reply({"exist": ok})
            elif self.path == "/receive_heart_beat":
                ok = controller.receive_heart_beat(
                    body["worker_name"], body.get("queue_length", 0))
                self._reply({"exist": ok})
            elif self.path == "/list_models":
                self._reply({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._reply(
                    {"address": controller.get_worker_address(body["model"])})
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in controller.generate_stream(body):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self._reply({"error": "unknown route"}, 404)

    return Handler


def serve(controller: Controller, host: str = "127.0.0.1",
          port: int = 10000) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def main(argv=None):
    import argparse
    import time as _time

    p = argparse.ArgumentParser("faithdiff-controller")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10000)
    p.add_argument("--dispatch", choices=["lottery", "shortest_queue"],
                   default="shortest_queue")
    args = p.parse_args(argv)
    controller = Controller(dispatch_method=args.dispatch)
    server = serve(controller, args.host, args.port)
    print(f"controller at http://{args.host}:{args.port}", flush=True)
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        controller.stop()
        server.shutdown()


if __name__ == "__main__":
    main()
