"""`program_trace.py` and the readers over the program's spans on the CPU:
self time, the device trace's gaps charged to the innermost span open on
the host (summing to the trace's gap time), the busy time of the kernels
launched inside each span, the kernels launched inside the `fp8_upcast`
ranges, the twelve readers on synthetic records, and a tiny set-up and
request recorded by the real program."""
import types

import pytest

import harness
import program_spans
import program_trace

MS = 1_000_000          # ns
READERS = [n for n, _ in program_spans.PROGRAM_METRICS + program_spans.FP8_METRICS]


def _span(sid, name, parent, start_ms, end_ms, device_ms=None, counters=None, **attrs):
    return dict(id=sid, name=name, parent=parent, attrs=attrs,
                start_ns=start_ms * MS, end_ns=end_ms * MS, host_ms=end_ms - start_ms,
                device_start_ms=start_ms, device_end_ms=start_ms + (device_ms or end_ms - start_ms),
                device_ms=device_ms or end_ms - start_ms, counters=counters or {})


def _request_spans():
    """request [0, 100] ms: restore [5, 80] (encode [5, 20], step [20, 60]
    with unet [25, 50]), decode [85, 98]."""
    return [_span(0, "request", None, 0, 100, index=0),
            _span(1, "restore", 0, 5, 80, device_ms=90),
            _span(2, "encode", 1, 5, 20, device_ms=12),
            _span(3, "step", 1, 20, 60, device_ms=50, i=0),
            _span(4, "unet", 3, 25, 50, device_ms=45, counters={"fp8.upcasts": 805}, rows=4),
            _span(5, "decode", 0, 85, 98, device_ms=10)]


def _kernels(*intervals_ms, base_ms=0):
    """Device-trace kernels over (start, end) ms, as µs from the base."""
    return [dict(cat="kernel", name="k", ts=(s - base_ms) * 1e3, dur=(t - s) * 1e3)
            for s, t in intervals_ms]


def test_self_time_is_the_duration_less_the_children():
    own = program_trace.self_ms(_request_spans())
    assert own[3] == 5 and own[4] == 45 and own[1] == 90 - 12 - 50
    host = program_trace.self_ms(_request_spans(), "host_ms")
    assert host[0] == 100 - 75 - 13 and host[3] == 40 - 25


def test_idle_is_charged_to_the_innermost_span_and_sums_to_the_gaps():
    # kernels from -10 ms (before the request) to 99 ms; gaps -5..2 (outside
    # then request), 30..40 (unet), 55..70 (step, then restore), 90..95
    # (decode); the trace's times are µs from a base of 1000 ms
    events = _kernels((-10, -5), (2, 30), (40, 55), (70, 90), (95, 99), base_ms=1000)
    events += _kernels((50, 52), base_ms=1000)            # inside a busy stretch
    idle = program_trace.idle_by_span(_request_spans(), events, base_ns=1000 * MS)
    want = {program_trace.OUTSIDE: 5, "request": 2, "unet": 10, "step": 5,
            "restore": 10, "decode": 5}
    assert idle["idle_ms"] == pytest.approx(want)
    assert idle["gap_ms"] == pytest.approx(37) == sum(idle["idle_ms"].values())
    assert idle["count"] == {"request": 1, "restore": 1, "encode": 1, "step": 1,
                             "unet": 1, "decode": 1}
    assert program_trace.device_gaps_ns(_kernels((0, 5), (3, 4)), 0) == []


def _launched(*kernels_ms, base_ms=0, first=1):
    """Kernels with their launches: (launch, start, end) ms, the trace's
    times µs from the base, correlation ids from `first`."""
    ev = []
    for corr, (launch, s, t) in enumerate(kernels_ms, first):
        ev.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=(launch - base_ms) * 1e3,
                       dur=1, args={"correlation": corr}))
        ev.append(dict(cat="kernel", name="k", ts=(s - base_ms) * 1e3, dur=(t - s) * 1e3,
                       args={"correlation": corr}))
    return ev


def test_busy_time_by_the_span_that_launched_it():
    """A kernel's busy time goes to the span innermost on the host at its
    launch (by correlation), whenever it runs; a kernel without a launch
    is left out, a launch outside every span is OUTSIDE; overlapping
    kernels count once."""
    events = _launched((3, 10, 14), (27, 30, 40), (26, 35, 45), (30, 60, 70), (52, 71, 72),
                       (100.5, 101, 102), base_ms=1000)
    events += _kernels((200, 300), base_ms=1000)              # no launch
    busy = program_trace.busy_by_span(_request_spans(), events, base_ns=1000 * MS)
    assert busy == pytest.approx({"request": 4, "unet": 15 + 10, "step": 1,
                                  program_trace.OUTSIDE: 1})
    assert program_trace.busy_by_span(_request_spans(), _kernels((0, 5)), 0) == {}


def test_upcast_kernels_by_launch_correlation():
    ev = [dict(cat="user_annotation", name="fp8_upcast", ts=10, dur=5),
          dict(cat="user_annotation", name="fp8_upcast", ts=30, dur=5),
          dict(cat="user_annotation", name="unet", ts=0, dur=100)]
    for corr, launch, dur in ((1, 11, 4.0), (2, 20, 9.0), (3, 33, 6.0)):
        ev.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=launch, dur=1,
                       args={"correlation": corr}))
        ev.append(dict(cat="kernel", name="direct_copy_kernel", ts=launch + 50, dur=dur,
                       args={"correlation": corr}))
    assert program_trace.upcast_kernels(ev) == dict(ranges=2, kernels=2, kernel_ms=0.010)


def _program_run():
    setup = [_span(0, "build_pipeline", None, 0, 2000, device_ms=1500, use_fp8=True),
             _span(1, "restore", None, 2500, 4000, device_ms=1600),
             _span(2, "encode", 1, 2500, 2700),
             _span(3, "decode", None, 4000, 4300, device_ms=200)]
    spans = _request_spans()
    spans.append(_span(6, "step", 1, 60, 79, device_ms=30, i=1))
    spans.append(_span(7, "unet", 6, 61, 75, device_ms=27, counters={"fp8.upcasts": 805},
                       rows=4))
    # (B): kernels launched in the UNet calls busy 30 + 20 ms, in the steps'
    # own time 2 + 1 ms, in encode 5 ms
    events = _launched((26, 30, 60), (62, 62, 82), (55, 60, 62), (77, 85, 86), (10, 10, 15))
    idle = dict(program_trace.idle_by_span(spans, events, 0),
                busy_ms=program_trace.busy_by_span(spans, events, 0))
    upcast = dict(ranges=1610, kernels=1610, kernel_ms=20.0, unet_calls=2, upcasts=1610)
    return types.SimpleNamespace(program=dict(setup=setup, spans=spans, idle=idle,
                                              upcast=upcast, wall_s=0.1))


def test_the_twelve_readers_on_synthetic_records():
    run = _program_run()
    got = {n: harness.reader(n)(run) for n in READERS}
    assert got == pytest.approx({
        "unet.host_ms_per_call": (25 + 14) / 2, "unet.span_ms_per_call": (45 + 27) / 2,
        "unet.idle_ms_per_call": (45 + 27) / 2 - 50 / 2,
        "loop.span_ms_per_step": (50 + 30) / 2,
        "loop.self_ms_per_step": (5 + 3) / 2, "loop.idle_ms_per_step": (5 + 3) / 2 - 3 / 2,
        "encode.span_ms_per_image": 12, "decode.span_ms_per_image": 10,
        "setup.pipeline_s": 2.0, "setup.warm_restore_s": 1.8,
        "fp8.upcasts_per_call": 805, "fp8.upcast_ms_per_call": 10.0})
    assert len(READERS) == 12


def test_readers_give_nothing_without_the_programs_records():
    bare = types.SimpleNamespace(records=[], spans={}, trace_summary={}, geometry={})
    empty = types.SimpleNamespace(program={})
    bf16 = _program_run()
    for s in bf16.program["spans"]:
        s["counters"] = {}
    del bf16.program["upcast"]
    for n in READERS:
        assert harness.reader(n)(bare) is None and harness.reader(n)(empty) is None, n
    assert harness.reader("fp8.upcasts_per_call")(bf16) is None
    assert harness.reader("fp8.upcast_ms_per_call")(bf16) is None


def test_span_table_sums_by_name():
    rows = {r[0]: r for r in program_spans.span_table(_program_run().program)}
    assert rows["unet"] == ["unet", 2, 39, 72, 72, pytest.approx(2 * 11)]
    assert rows["step"][4] == 8 and rows["step"][5] == pytest.approx(2 * 2.5)
    assert rows["encode"][5] == pytest.approx(12 - 5)


def test_a_tiny_set_up_and_request_recorded_by_the_program(tiny_inputs, monkeypatch):
    """The real program on the CPU at the tiny widths: its set-up's spans
    and a request's feed the readers; a program without a recorder gets no
    recorded requests."""
    from faithdiff_tpu_torch.utils import profiling

    _, config, traffic, _ = tiny_inputs
    run = harness.Run(config, traffic, 2 ** 31 + 77, "cpu", {})
    drv = harness.driver(traffic["driver"]).Driver(run)
    with profiling.recording() as rec:
        drv.setup()
    spans, wall, events, _ = program_trace.recorded(drv.request, 0)
    assert events is None and wall > 0
    run.program = dict(setup=rec.take(), spans=spans)
    got = {n: harness.reader(n)(run) for n in READERS}
    for n in ("unet.host_ms_per_call", "unet.span_ms_per_call", "loop.span_ms_per_step",
              "loop.self_ms_per_step", "encode.span_ms_per_image",
              "decode.span_ms_per_image", "setup.pipeline_s", "setup.warm_restore_s"):
        assert got[n] is not None and got[n] > 0, n
    assert got["unet.idle_ms_per_call"] is None and got["fp8.upcasts_per_call"] is None
    steps = config["pipeline"]["num_inference_steps"]
    assert [s["name"] for s in spans].count("step") == steps
    monkeypatch.setattr(program_trace, "_profiling", lambda: None)
    assert program_trace.unprofiled_request(drv.request, 1) == {}
    assert program_trace.profiled_requests(drv.request, 1, True) == {}
