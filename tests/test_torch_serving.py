"""The port's serving stack (`faithdiff_tpu_torch/serving/`) on the CPU,
against the JAX package's: registry, heartbeats and expiry, dispatch and
streaming end to end through real HTTP sockets, failover, lottery draws,
the external backend, the chat CLI, the worker's `main` over a stub
captioner, and the web demo's restore on the tiny pipeline against the JAX
demo's restore on the same weights."""
import argparse
import base64
import io
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.config import (tiny_denoise_encoder_config,
                                  tiny_unet_config, tiny_vae_config)
from faithdiff_tpu.pipelines.factory import build_pipeline as jax_build_pipeline
from faithdiff_tpu.serving import controller as jax_ctl
from faithdiff_tpu.serving import web_demo as jax_demo
from faithdiff_tpu.serving import worker as jax_wk
from faithdiff_tpu_torch import cli
from faithdiff_tpu_torch.models import vae as tvae
from faithdiff_tpu_torch.serving import chat
from faithdiff_tpu_torch.serving import controller as ctl
from faithdiff_tpu_torch.serving import web_demo
from faithdiff_tpu_torch.serving import worker as wk
from faithdiff_tpu_torch.serving.external_worker import make_external_worker
from faithdiff_tpu_torch.utils.png import decode_png, encode_png
from test_torch_cli import ckpt, one_intra_op_thread  # noqa: F401  (fixtures)

MODEL = "faithdiff-captioner"


def _post(addr, path, payload):
    req = urllib.request.Request(
        addr + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _words(params):
    yield from ["a", "tiny", "caption"]


@pytest.fixture
def stack():
    cport = _free_port()
    controller = ctl.Controller(dispatch_method="shortest_queue")
    cserver = ctl.serve(controller, port=cport)
    caddr = f"http://127.0.0.1:{cport}"
    wport = _free_port()
    waddr = f"http://127.0.0.1:{wport}"
    worker = wk.ModelWorker(caddr, waddr, [MODEL], _words)
    wserver = wk.serve(worker, port=wport)
    yield controller, caddr, worker, waddr
    worker.stop()
    controller.stop()
    cserver.shutdown()
    wserver.shutdown()


def _texts(raw):
    chunks = [json.loads(c) for c in raw.split(b"\0") if c.strip()]
    assert all(c["error_code"] == 0 for c in chunks)
    return [c["text"] for c in chunks]


def test_register_and_list_models(stack):
    _, caddr, _, _ = stack
    assert json.loads(_post(caddr, "/list_models", {}))["models"] == [MODEL]


def test_dispatch_and_stream_end_to_end(stack):
    _, caddr, _, waddr = stack
    out = json.loads(_post(caddr, "/get_worker_address", {"model": MODEL}))
    assert out["address"] == waddr
    raw = _post(caddr, "/worker_generate_stream", {"model": MODEL})
    assert _texts(raw) == ["a", "tiny", "caption"]


def test_heartbeat_updates_and_expiry(stack, monkeypatch):
    """A heartbeat updates the queue; with the expiry constant patched to
    below zero every worker is stale at once (no waiting through 30 s)."""
    controller, _, _, waddr = stack
    assert controller.receive_heart_beat(waddr, 3)
    assert controller.workers[waddr].queue_length == 3
    assert controller.remove_stale_workers() == []
    monkeypatch.setattr(ctl, "CONTROLLER_HEART_BEAT_EXPIRATION", -1)
    assert controller.remove_stale_workers() == [waddr]
    assert waddr not in controller.workers
    assert not controller.receive_heart_beat(waddr, 0)


def test_failover_to_next_worker(stack):
    """A dead worker with the shorter queue is tried first, dropped, and the
    request fails over to the live one."""
    controller, caddr, _, waddr = stack
    dead_addr = "http://127.0.0.1:1"          # nothing listening
    controller.register_worker(dead_addr, True, {
        "model_names": [MODEL], "speed": 1.0, "queue_length": 0})
    controller.workers[waddr].queue_length = 10
    raw = _post(caddr, "/worker_generate_stream", {"model": MODEL})
    assert _texts(raw) == ["a", "tiny", "caption"]
    assert dead_addr not in controller.workers


def test_no_worker_for_unknown_model(stack):
    _, caddr, _, _ = stack
    out = json.loads(_post(caddr, "/get_worker_address", {"model": "nope"}))
    assert out["address"] == ""
    raw = _post(caddr, "/worker_generate_stream", {"model": "nope"})
    (chunk,) = [json.loads(c) for c in raw.split(b"\0") if c.strip()]
    assert chunk["error_code"] == 2


def test_lottery_picks_equal_jax_controllers():
    """Speed-weighted draws: the same picks as the JAX controller from the
    same seeded generator, and the fast worker most of the time."""
    picks = []
    for module in (ctl, jax_ctl):
        controller = module.Controller(dispatch_method="lottery")
        for name, speed in (("w_fast", 100.0), ("w_mid", 7.0), ("w_slow", 1.0)):
            controller.register_worker(name, False, {
                "model_names": ["m"], "speed": speed, "queue_length": 0})
        rng = np.random.default_rng(0)
        picks.append([controller.get_worker_address("m", rng) for _ in range(200)])
        controller.stop()
    assert picks[0] == picks[1]
    assert picks[0].count("w_fast") > 160


def _boom(params):
    yield "partial"
    raise RuntimeError("the model failed")


@pytest.mark.parametrize("generate", [_words, _boom], ids=["words", "error"])
def test_worker_stream_bytes_equal_jax(generate):
    """The worker's framing (`json + b"\\0"` a chunk, the error sentinel)
    byte for byte as the JAX worker's, for the same generate_fn."""
    ours = wk.ModelWorker("http://127.0.0.1:1", "w", [MODEL], generate,
                          register=False)
    theirs = jax_wk.ModelWorker("http://127.0.0.1:1", "w", [MODEL], generate,
                                register=False)
    got = list(ours.generate_stream({"model": MODEL}))
    assert got == list(theirs.generate_stream({"model": MODEL}))
    assert got[-1].endswith(b"\0") and ours.queue_length == 0


def test_external_backend_worker_end_to_end():
    """Controller -> external worker -> a stub backend streaming
    line-delimited cumulative JSON, streamed back."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Backend(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            assert json.loads(self.rfile.read(n))["model"] == "llava-ext"
            self.send_response(200)
            self.end_headers()
            for w in ["ext", "ext backend", "ext backend caption"]:
                self.wfile.write(json.dumps({"text": w}).encode() + b"\n")
                self.wfile.flush()

    bport = _free_port()
    bserver = ThreadingHTTPServer(("127.0.0.1", bport), Backend)
    threading.Thread(target=bserver.serve_forever, daemon=True).start()
    cport = _free_port()
    controller = ctl.Controller(dispatch_method="shortest_queue")
    cserver = ctl.serve(controller, port=cport)
    caddr = f"http://127.0.0.1:{cport}"
    wport = _free_port()
    worker = make_external_worker(caddr, f"http://127.0.0.1:{wport}",
                                  ["llava-ext"],
                                  backend_url=f"http://127.0.0.1:{bport}/generate")
    wserver = wk.serve(worker, port=wport)
    try:
        raw = _post(caddr, "/worker_generate_stream",
                    {"model": "llava-ext", "prompt": "hi"})
        assert _texts(raw) == ["ext", "ext backend", "ext backend caption"]
    finally:
        worker.stop()
        controller.stop()
        for s in (cserver, wserver, bserver):
            s.shutdown()


class StubAgent:
    """A captioner that echoes: its caption names the image's mean and the
    question."""
    temperature = 0.2
    max_new_tokens = 16

    def __init__(self):
        self.calls = []

    def caption(self, img, question="describe"):
        self.calls.append((img.shape, question))
        return f"mean {float(img.mean()):.3f}: {question[-20:]}"


def test_chat_cli_carries_history(monkeypatch, tmp_path):
    """The chat loop reads the PNG with the port's reader and drives the
    agent with the running conversation."""
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    (tmp_path / "x.png").write_bytes(encode_png(img))
    agent = StubAgent()
    seen = {}

    def from_checkpoint(d, **kw):
        seen.update(kw, dir=d)
        return agent

    monkeypatch.setattr("faithdiff_tpu_torch.captioner.agent.CaptionAgent."
                        "from_checkpoint", staticmethod(from_checkpoint))
    inputs = iter(["hello", "more"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(inputs))
    with pytest.raises(StopIteration):
        chat.main(["--captioner_dir", "fake", "--image", str(tmp_path / "x.png"),
                   "--device", "cpu"])
    assert seen == {"dir": "fake", "device": "cpu"}
    assert [q for _, q in agent.calls][0] == "hello"
    assert "hello" in agent.calls[1][1] and agent.calls[1][1].endswith("more")
    assert agent.calls[0][0] == (8, 8, 3)
    (tmp_path / "y.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match=r"y\.jpg: truncated JPEG"):
        chat.main(["--captioner_dir", "fake", "--image", str(tmp_path / "y.jpg")])


def test_worker_main_captions_uploads_through_the_controller(monkeypatch):
    """`worker.main` with the JAX worker's flags (`--load_4bit`) over a stub
    captioner: registers, and a base64 PNG through the controller is
    decoded by `decode_image` and captioned with the request's prompt."""
    agent = StubAgent()
    seen = {}

    def from_checkpoint(d, **kw):
        seen.update(kw)
        return agent

    monkeypatch.setattr("faithdiff_tpu_torch.captioner.agent.CaptionAgent."
                        "from_checkpoint", staticmethod(from_checkpoint))
    cport, wport = _free_port(), _free_port()
    controller = ctl.Controller()
    cserver = ctl.serve(controller, port=cport)
    caddr = f"http://127.0.0.1:{cport}"
    img = np.random.default_rng(1).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    replies = []

    def serve_then_stop(seconds):
        body = {"model": "llava", "image": base64.b64encode(encode_png(img)).decode(),
                "prompt": "what is here?"}
        replies.append(_post(caddr, "/worker_generate_stream", body))
        raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", serve_then_stop)
    try:
        wk.main(["--controller", caddr, "--port", str(wport), "--captioner_dir",
                 "ckpt", "--load_4bit", "--device", "cpu"])
    finally:
        controller.stop()
        cserver.shutdown()
    assert seen == {"load_8bit": False, "load_4bit": True, "device": "cpu"}
    assert _texts(replies[0]) == [StubAgent().caption(img, "what is here?")]


STEPS = 2


def _png_b64(img):
    return base64.b64encode(encode_png(img)).decode()


def test_web_demo_restore_matches_jax_demo(ckpt, monkeypatch):  # noqa: F811
    """`DemoApp.handle_restore` of `web_demo.make_restore_fn` on the tiny
    pipeline of the port's checkpoint against the JAX demo's restore on the
    same params (reached through its `main`, `serve` patched): within 1
    uint8 level, the CLI parity test's tolerance. Both sides take the same
    initial latents (torch's, from the seed) and JAX's posterior noise."""
    img = np.random.default_rng(7).integers(0, 256, (15, 31, 3), dtype=np.uint8)
    body = {"image": _png_b64(img), "steps": STEPS, "seed": 42, "hdr": 0.0}
    p = ckpt["params"]
    jpipe = jax_build_pipeline(
        unet_config=tiny_unet_config(), vae_config=tiny_vae_config(),
        denoise_encoder_config=tiny_denoise_encoder_config(),
        pipeline_config=JaxPipelineConfig(num_inference_steps=STEPS),
        unet_params=p["unet"], vae_params=p["vae"],
        denoise_encoder_params=p["denoise_encoder"], dtype=jnp.float32)
    apps = []
    monkeypatch.setattr("faithdiff_tpu.cli.load_checkpointed_pipeline",
                        lambda args: lambda *a, **kw: jpipe(*a, noise_source="torch", **kw))
    monkeypatch.setattr("faithdiff_tpu.cli._make_text_encoder", lambda args: None)
    monkeypatch.setattr(jax_demo, "serve", lambda app, host, port: apps.append(app))
    monkeypatch.setattr(time, "sleep", lambda s: (_ for _ in ()).throw(KeyboardInterrupt))
    jax_demo.main(["--tiny", "--num_inference_steps", str(STEPS)])
    want = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        apps[0].handle_restore(body)["image"]))))

    key = jax.random.split(jax.random.PRNGKey(42), 3)[2]
    noise = np.asarray(jax.random.normal(key, (1, 4, 8, 4), jnp.float32))
    monkeypatch.setattr(tvae, "posterior_noise", lambda shape, generator, device:
                        torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))
    pargs = argparse.Namespace(
        num_inference_steps=STEPS, guidance_scale=5.0, latent_tiled_size=1024,
        latent_tiled_overlap=0.5, start_point="lr", color_fix="wavelet",
        use_tile_vae=False, use_fp8=False, tiny=True, checkpoint_dir=ckpt["dir"],
        tokenizer_dir=None, device="cpu")
    app = web_demo.DemoApp(web_demo.make_restore_fn(cli.load_checkpointed_pipeline(pargs)))
    got = decode_png(base64.b64decode(app.handle_restore(body)["image"]))
    assert got.shape == want.shape == (30, 62, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_web_demo_serves_the_page_and_refuses_jpeg():
    """`GET /` is the JAX demo's page; a truncated JPEG upload is answered
    with an error naming the upload over HTTP, a whole one is decoded as
    Pillow decodes it, and an unknown route is answered with an error, as
    the JAX demo answers it."""
    calls = []
    app = web_demo.DemoApp(lambda img, caption, **o: calls.append(img) or img)
    port = _free_port()
    server = web_demo.serve(app, "127.0.0.1", port)
    addr = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(addr + "/", timeout=10) as r:
            assert r.read() == jax_demo._PAGE.encode()
        jpeg = base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(16)).decode()
        out = json.loads(_post(addr, "/restore", {"image": jpeg}))
        assert out == {"error": "the uploaded image: truncated JPEG segment"}
        assert json.loads(_post(addr, "/caption", {"image": jpeg})) == {
            "error": "no captioner loaded"}
        assert json.loads(_post(addr, "/nope", {})) == {"error": "unknown route"}
        img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), dtype=np.uint8)
        out = json.loads(_post(addr, "/restore", {"image": _png_b64(img)}))
        assert np.array_equal(decode_png(base64.b64decode(out["image"])), img)
        assert calls and calls[0].shape == (5, 7, 3)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        out = json.loads(_post(addr, "/restore", {
            "image": base64.b64encode(buf.getvalue()).decode()}))
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        assert np.array_equal(calls[-1], want)
        assert np.array_equal(decode_png(base64.b64decode(out["image"])), want)
    finally:
        server.shutdown()
