"""External-backend worker (counterpart of
`faithdiff_tpu/serving/external_worker.py`, which holds no model; the port
keeps its own copy).

A worker that speaks the controller's registration, heartbeat and
streaming protocol but delegates generation to an external inference
server over HTTP: any server that takes a JSON POST and streams
line-delimited JSON `{"text": ...}` chunks, each the text so far (SGLang's
`/generate` stream format).

Usage:
    worker = make_external_worker(
        controller_addr="http://127.0.0.1:21001",
        worker_addr="http://127.0.0.1:40002",
        model_names=["llava-ext"],
        backend_url="http://backend:30000/generate")
    serve(worker, port=40002)
"""
from __future__ import annotations

import json
import urllib.request
from typing import Iterator, List

from .worker import ModelWorker, serve  # noqa: F401  (re-export serve)


def stream_external(backend_url: str, params: dict,
                    timeout: float = 120.0) -> Iterator[str]:
    """POST `params` to the external server and yield cumulative text from
    its line-delimited JSON stream (SGLang `/generate` semantics: each line
    carries the full text so far)."""
    req = urllib.request.Request(
        backend_url, data=json.dumps(params).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            raw = raw.strip().rstrip(b"\0")
            if not raw:
                continue
            payload = json.loads(raw)
            if payload.get("error_code", 0):
                raise RuntimeError(payload.get("text_error", "backend error"))
            yield payload.get("text", "")


def make_external_worker(
    controller_addr: str,
    worker_addr: str,
    model_names: List[str],
    backend_url: str,
    limit_concurrency: int = 5,
    register: bool = True,
) -> ModelWorker:
    """A ModelWorker whose generation is proxied to `backend_url`."""

    def generate_fn(params: dict) -> Iterator[str]:
        return stream_external(backend_url, params)

    return ModelWorker(
        controller_addr=controller_addr,
        worker_addr=worker_addr,
        model_names=model_names,
        generate_fn=generate_fn,
        limit_concurrency=limit_concurrency,
        register=register,
    )
