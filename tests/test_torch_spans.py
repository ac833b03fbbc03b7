"""The program's spans and counters (`utils/profiling.span`, `count`,
`leaf`, `recording`) on the CPU, through the tiny pipeline: with the
recorder off a restore enters no profiler range and records and counts
nothing; with it on, the span tree of a request (restore, encode, a step
each, a UNet call each chunk, decode) and the fp8 upcasts counted once a
stored tensor a call; the same latents either way; the spans' host stamps
on the clock of the profiler's Chrome trace; and the recorder's buffer,
counters and threads."""
import json
import math
import threading

import numpy as np
import pytest
import torch

from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import layers
from faithdiff_tpu_torch.models.layers import store_fp8_
from faithdiff_tpu_torch.ops.autograd import with_plain_backward
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils import profiling
from faithdiff_tpu_torch.utils.quantize import quantize_params_fp8

# 64x128 px at tile_size 64: 3 latent tiles, in UNet calls of 2 and 1
H, W, STEPS, CHUNK, TILES = 64, 128, 2, 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def host_clock(monkeypatch):
    """The tiny pipeline runs on the CPU: its spans take the host's clock
    for their device times, on a machine with a card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _pipeline(fp8: bool):
    """The tiny bf16 pipeline; with `fp8` its UNet's weights stored in fp8
    as `build_pipeline(use_fp8=True)` stores them. Returns (pipeline, the
    number of tensors `store_fp8_` stored)."""
    pipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=STEPS),
        dtype=torch.bfloat16, device="cpu", tile_chunk=CHUNK)
    n = store_fp8_(pipe.unet, quantize_params_fp8(pipe.unet.state_dict(),
                                                  torch.bfloat16)) if fp8 else 0
    return pipe, n


@pytest.fixture(scope="module")
def pipes():
    return {"bf16": _pipeline(False), "fp8": _pipeline(True)}


@pytest.fixture(scope="module")
def request_inputs():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.standard_normal((1, 77, 64)).astype(np.float32),
            rng.standard_normal((1, 64)).astype(np.float32))


def _request(pipe, inputs, index=0):
    img, pe, pooled = inputs
    with profiling.span("request", index=index):
        lat = pipe(img, pe, pooled, seed=11, output_type="latent")
        out = pipe.decode(lat, img, output_type="uint8")
    return lat, out


@pytest.mark.parametrize("kind", ["bf16", "fp8"])
def test_off_path_enters_no_range_and_records_nothing(pipes, request_inputs,
                                                      monkeypatch, kind):
    """Recorder off, no profiler: no `record_function` is entered, no span
    object made, nothing counted and no upcast range opened."""
    def refuse(*args, **kwargs):
        raise AssertionError("entered with the recorder off")

    for target in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(target, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling, "count", refuse)
    monkeypatch.setattr(profiling, "leaf", refuse)
    assert not profiling.recording_on()
    lat, out = _request(pipes[kind][0], request_inputs)
    assert lat.shape == (1, H // 8, W // 8, 4) and out.shape == (H, W, 3)
    assert profiling.span("a", i=1) is profiling.span("b") is profiling._NULL


@pytest.mark.parametrize("kind", ["bf16", "fp8"])
def test_span_tree_of_a_request(pipes, request_inputs, kind):
    """One restore under the request, its encode, a step a denoising step,
    ceil(tiles / chunk) UNet calls a step with their rows, the decode under
    the request; fp8 upcasts counted into each UNet call, one a stored
    tensor, and nowhere else."""
    pipe, stored = pipes[kind]
    with profiling.recording() as rec:
        _request(pipe, request_inputs, index=7)
    spans = rec.take()
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    calls = math.ceil(TILES / CHUNK)
    assert names == (["request", "restore", "encode"]
                     + (["step"] + ["unet"] * calls) * STEPS + ["decode"])
    request, restore, encode = spans[:3]
    assert request["parent"] is None and request["attrs"] == {"index": 7}
    assert restore["parent"] == request["id"] and restore["attrs"] == dict(
        h=H, w=W, tiles=TILES, chunk=CHUNK, steps=STEPS)
    assert encode["parent"] == restore["id"] and spans[-1]["parent"] == request["id"]
    steps = [s for s in spans if s["name"] == "step"]
    assert [s["attrs"] for s in steps] == [{"i": i} for i in range(STEPS)]
    assert all(s["parent"] == restore["id"] for s in steps)
    unets = [s for s in spans if s["name"] == "unet"]
    assert [s["attrs"]["rows"] for s in unets] == [4, 2] * STEPS
    assert all(by_id[s["parent"]]["name"] == "step" for s in unets)
    for s in spans:
        want = {"fp8.upcasts": stored} if s["name"] == "unet" and stored else {}
        assert s["counters"] == want, s["name"]
    assert (kind == "fp8") == (stored > 0) and not rec.counters and rec.dropped == 0
    for s in spans:                     # no card: device times are the host's
        assert s["device_ms"] == pytest.approx(s["host_ms"]) and s["host_ms"] >= 0
        assert s["start_ns"] <= s["end_ns"]
    for s in spans[1:]:
        parent = by_id[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]


def test_recorder_leaves_the_output_bit_identical(pipes, request_inputs):
    pipe = pipes["fp8"][0]
    off = _request(pipe, request_inputs)
    with profiling.recording():
        on = _request(pipe, request_inputs)
    assert torch.equal(off[0], on[0]) and np.array_equal(off[1], on[1])


def test_span_stamps_on_the_profilers_clock(pipes, request_inputs, tmp_path):
    """Under a CPU profiler with the recorder on, each span is a range of
    the Chrome trace, its host stamps within 1 ms of the range's ends
    (`baseTimeNanoseconds` + 1000 ts), and each fp8 upcast a leaf range."""
    pipe, stored = pipes["fp8"]
    with profiling.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _request(pipe, request_inputs)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3))
    spans = rec.take()
    for s in spans:
        r = min(ranges[s["name"]], key=lambda r: abs(r[0] - s["start_ns"]))
        assert abs(r[0] - s["start_ns"]) < 1e6 and abs(r[1] - s["end_ns"]) < 1e6, s["name"]
    unet_calls = sum(s["name"] == "unet" for s in spans)
    assert len(ranges["fp8_upcast"]) == stored * unet_calls


def test_recorder_buffer_counters_and_nesting(monkeypatch):
    """The buffer keeps `RECORD_LIMIT` spans and counts the rest; a count
    outside any span goes to the recording; counts stop with the block; one
    recording at a time; under a profiler alone a span is a range."""
    monkeypatch.setattr(profiling, "RECORD_LIMIT", 2)
    with profiling.recording() as rec:
        profiling.count("outside", 3)
        with profiling.span("a", k=1):
            profiling.count("n")
            with profiling.span("b"):
                profiling.count("n", 2)
                profiling.count("bytes", 10)
        with profiling.span("c"):
            pass
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    profiling.count("outside")
    assert not profiling.recording_on()
    spans = rec.take()
    assert [(s["name"], s["parent"], s["counters"]) for s in spans] == [
        ("a", None, {"n": 1}), ("b", spans[0]["id"], {"n": 2, "bytes": 10})]
    assert spans[0]["attrs"] == {"k": 1} and rec.dropped == 1
    assert dict(rec.counters) == {"outside": 3}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("x"), torch.profiler.record_function)
        assert profiling.leaf("x") is profiling._NULL     # recorder off


def test_spans_of_two_threads_have_their_own_parents():
    def work(tag):
        with profiling.span("outer", tag=tag):
            with profiling.span("inner", tag=tag):
                pass

    with profiling.recording() as rec:
        with profiling.span("main"):
            t = threading.Thread(target=work, args=("thread",))
            t.start()
            t.join()
            work("main")
    spans = rec.take()
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "outer":
            want = None if s["attrs"]["tag"] == "thread" else "main"
            assert (by_id[s["parent"]]["name"] if s["parent"] is not None else None) == want
        if s["name"] == "inner":
            assert by_id[s["parent"]]["attrs"] == s["attrs"]


def test_plain_backward_is_a_span():
    """`KernelWithPlainBackward`'s backward is the span
    `plain_backward:<plain's name>`."""
    def kernel(x):
        return x * 2.0

    def doubled(x):
        return x * 2.0

    x = torch.ones(3, requires_grad=True)
    with profiling.recording() as rec:
        with_plain_backward(kernel, doubled, x).sum().backward()
    assert [s["name"] for s in rec.take()] == ["plain_backward:doubled"]
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_upcast_reads_its_dtype_and_counts_only_when_on():
    up = layers._Upcast(torch.bfloat16)
    stored = torch.ones(4, 8).to(torch.float8_e4m3fn)
    assert up(stored).dtype == torch.bfloat16
    with profiling.recording() as rec:
        with profiling.span("unet"):
            assert torch.equal(up(stored), torch.ones(4, 8, dtype=torch.bfloat16))
    assert rec.take()[0]["counters"] == {"fp8.upcasts": 1}


def test_recorder_under_many_threads_loses_no_span_or_count(monkeypatch):
    """More threads than cores, a short switch interval: every span is kept
    or counted as dropped, and no count outside a span is lost."""
    import sys

    threads, each = 16, 200
    interval = sys.getswitchinterval()
    monkeypatch.setattr(profiling, "RECORD_LIMIT", 1000)
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for _ in range(each):
                    with profiling.span("s"):
                        profiling.count("in")
                    profiling.count("out")

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = rec.take()
    assert len(spans) == 1000 and rec.dropped == threads * each - 1000
    assert rec.counters["out"] == threads * each
    assert all(s["counters"] == {"in": 1} and s["parent"] is None for s in spans)
