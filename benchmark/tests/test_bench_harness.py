"""The harness on the CPU: it finds each cell's files by name, keeps to the
names and limits of BENCHMARK.json's format, does the rate arithmetic, prints the result
line's keys, refuses to measure without a card, and reads a trace."""
import json
import math
import os
import re
import subprocess
import sys
import types

import pytest

import harness
import trace_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in ([w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]] + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_names_files_that_exist(cell):
    w, config, traffic, limits = harness.cell_inputs(SPEC, cell)
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("benchmark/configs/")
    assert config["name"] == w["config"] and config["reduced"] == entry["reduced"]
    assert os.path.exists(os.path.join(harness.BENCH, "drivers", traffic["driver"] + ".py"))
    assert limits and all(v > 0 for v in limits.values())
    assert hasattr(harness.driver(traffic["driver"]), "Driver")
    for m in harness.cell_metrics(SPEC, cell, False) + harness.cell_metrics(SPEC, cell, True):
        assert callable(harness.reader(m["name"]))
    assert {m["name"] for m in harness.cell_metrics(SPEC, cell, False)} >= {"setup_s"}
    assert harness.cell_metrics(SPEC, cell, True)


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)


def _run(records, **kw):
    fields = dict(records=records, spans={}, trace_summary={}, geometry={},
                  peak_bytes=0, setup_s=None)
    run = types.SimpleNamespace(**dict(fields, **kw))
    run.done = lambda: [r for r in records if not r.get("error")]
    return run


def test_rate_counts_whole_images_over_first_start_to_last_end():
    rate = harness.reader("restore_mpix_per_s")
    steady = [dict(start=4.0 * i, end=4.0 * i + 4.0, pixels=1_572_864) for i in range(3)]
    assert rate(_run(steady)) == pytest.approx(3 * 1.572864 / 12.0)
    # a stall between two images lowers it; so does a failed image
    stalled = [dict(r) for r in steady]
    stalled[2].update(start=10.0, end=14.0)
    assert rate(_run(stalled)) == pytest.approx(3 * 1.572864 / 14.0)
    failed = steady + [dict(start=12.0, end=12.5, pixels=0, error="x")]
    assert rate(_run(failed)) == pytest.approx(3 * 1.572864 / 12.5)


def test_readers_return_nothing_without_their_data():
    run = _run([])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if m["name"] != "setup_s":
            assert harness.reader(m["name"])(run) is None, m["name"]


def _trace(shift=0.0):
    """A request's host trace: kernels on one stream, launched from host
    ops, two of them inside a UNet range; `shift` moves every time."""
    ev = [dict(cat="user_annotation", name="bench.image", ts=0, dur=100),
          dict(cat="user_annotation", name="bench.unet", ts=10, dur=30),
          dict(cat="cpu_op", name="aten::linear", ts=11, dur=5),
          dict(cat="cpu_op", name="aten::copy_", ts=50, dur=5)]
    for corr, (launch, start, dur, name) in enumerate([
            (12, 20, 10, "void (anonymous namespace)::flash_fwd_kernel<64>"),
            (14, 25, 15, "sm90_xmma_gemm_bf16"),
            (51, 60, 10, "void (anonymous namespace)::gn_fused_kernel<bf16>"),
            (52, 80, 5, "direct_copy_kernel")]):
        ev.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=launch, dur=1,
                       args={"correlation": corr}))
        ev.append(dict(cat="kernel", name=name, ts=start, dur=dur,
                       args={"correlation": corr}))
    for e in ev:
        e["ts"] += shift
    return ev


def test_trace_reader():
    device = [e for e in _trace(1000.0) if e["cat"] == "kernel"]
    d = trace_reader.device_summary(device, wall_s=100e-6)
    h = trace_reader.host_summary(_trace())
    t = trace_reader.summarise(d, h)
    assert t["window_s"] == pytest.approx(100e-6)
    # kernels cover [20, 40], [60, 70] and [80, 85]: 35 us busy, 65 us span
    assert t["busy_s"] == pytest.approx(35e-6) and t["span_s"] == pytest.approx(65e-6)
    assert t["unet_calls"] == 1 and t["unet_launches"] == 2
    assert t["attention_s"] == pytest.approx(10e-6)
    assert t["group_norm_s"] == pytest.approx(10e-6)
    # the gaps 40-60 and 70-80 end at kernels that aten::copy_ launched; the
    # 35 us outside the kernels' span are the window's rest
    assert t["idle_gaps"]["aten::copy_"] == pytest.approx(30e-6)
    assert t["idle_gaps"][trace_reader.OUTSIDE] == pytest.approx(35e-6)
    assert sum(t["idle_gaps"].values()) == pytest.approx(t["window_s"] - t["busy_s"])
    run = _run([dict(start=0.0, end=70e-6, pixels=1), dict(start=1.0, end=1.0 + 70e-6, pixels=1)],
               trace_summary=t)
    assert harness.reader("device.idle_pct")(run) == pytest.approx(50.0)
    assert harness.reader("unet.launches_per_call")(run) == 2.0
    # a kernel the host trace lacks, and one it has more: the rest still align
    d2 = trace_reader.device_summary(
        device + [dict(cat="kernel", name="extra_kernel", ts=1090.0, dur=1.0)], 100e-6)
    t2 = trace_reader.summarise(d2, trace_reader.host_summary(_trace()))
    assert t2["idle_gaps"]["aten::copy_"] == pytest.approx(30e-6)
    assert trace_reader.align(["a", "b", "c"], dict(kernel_names=["a", "x", "b", "c"],
                                                     launch_ops=["1", "2", "3", "4"])) == ["1", "3", "4"]
    assert trace_reader.align(["a", "z", "b"], dict(kernel_names=["a", "b"],
                                                     launch_ops=["1", "2"])) == ["1", "unattributed", "2"]


def test_trace_without_the_request_range_gives_nothing():
    assert trace_reader.host_summary([e for e in _trace() if e["name"] != "bench.image"]) == {}
    assert trace_reader.device_summary([], 1.0) == {} and trace_reader.summarise({}, None) == {}


def test_result_line_on_the_cpu(tiny_inputs):
    """A whole run at the tiny widths on the CPU: the result's keys in the
    order the format gives, the compared numbers last, and `correct`."""
    result, checks, error = harness.run_cell("restore-1024x1536", 3_000_000_019, 0.5, False,
                                             "cpu", SPEC, inputs=tiny_inputs)
    assert error is None
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"restore_mpix_per_s", "setup_s"}
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [c[0] for c in checks] == list(result["check"])


def test_traced_result_on_the_cpu(tiny_inputs):
    result, _, error = harness.run_cell("restore-1024x1536", 7, 0.5, True, "cpu", SPEC,
                                        inputs=tiny_inputs)
    assert error is None and result["correct"] is True
    assert {"loop.ms_per_step", "unet.ms_per_call", "encode.ms_per_image",
            "decode.ms_per_image", "restore.mfu_pct"} <= set(result["metrics"])
    assert not {"restore_mpix_per_s", "setup_s"} & set(result["metrics"])


def test_same_seed_same_inputs_and_weights():
    import torch

    import generator
    import weights

    cfg = harness.load_json(os.path.join(os.path.dirname(__file__), "tiny_config.json"))
    a = weights.make_state_dicts(cfg, 2 ** 31 + 5, "cpu")
    b = weights.make_state_dicts(cfg, 2 ** 31 + 5, "cpu")
    assert all(torch.equal(a["unet"][k], b["unet"][k]) for k in a["unet"])
    t = harness.load_json(os.path.join(os.path.dirname(__file__), "tiny_traffic.json"))
    r1 = generator.make_requests(t, 2 ** 31 + 5, "cpu")
    r2 = generator.make_requests(t, 2 ** 31 + 5, "cpu")
    assert (r1[1].image == r2[1].image).all() and r1[1].noise_seed == r2[1].noise_seed
    assert not (r1[0].image == r1[1].image).all()
    assert generator.request_at(r1, 5, 9).noise_seed != generator.request_at(r1, 5, 1).noise_seed


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits nonzero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "run.py"),
                          "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "run.py"),
                          "--workload", CELLS[0], "--seed", "11", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
