"""The port's `utils/profiling.py` on the CPU, against the JAX package's
`utils/profiling.py`: the phase registry and its reports (the cases of
`tests/test_quant_profiling.py`), a Chrome trace written by `trace` with
a `span`'s range in it, and the trace's kernel split and busy share on a
hand-made timeline."""
import contextlib
import io
import json

import pytest
import torch

from faithdiff_tpu.utils import profiling as jax_profiling
from faithdiff_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def empty_registries():
    profiling.phase_report(reset=True)
    jax_profiling.phase_report(reset=True)
    yield
    profiling.phase_report(reset=True)
    jax_profiling.phase_report(reset=True)


def test_phase_timing():
    with profiling.phase("unit_test_phase"):
        sum(range(1000))
    rep = profiling.phase_report(reset=True)
    assert rep["unit_test_phase"]["count"] == 1
    assert rep["unit_test_phase"]["total_s"] >= 0
    assert profiling.phase_report() == {}


def test_phase_reports_have_jax_keys_counts_and_output():
    """The same phases through both modules: the same names, counts and
    keys, the printed lines' form and the saved JSON's."""
    for mod in (profiling, jax_profiling):
        for name in ("load", "denoise", "denoise", "decode"):
            with mod.phase(name, sync=torch.zeros(3) if mod is profiling else None):
                pass
    ours, theirs = profiling.phase_report(), jax_profiling.phase_report()
    assert {k: v["count"] for k, v in ours.items()} == {
        k: v["count"] for k, v in theirs.items()} == {"load": 1, "denoise": 2, "decode": 1}
    assert all(set(v) == set(theirs[k]) for k, v in ours.items())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profiling.print_phase_report(reset=False)
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "[phase] decode", "[phase] denoise", "[phase] load"]
    assert " n=2 " in lines[1] and "mean=" in lines[1] and "total=" in lines[1]


def test_save_phase_report(tmp_path):
    with profiling.phase("a"):
        pass
    profiling.save_phase_report(str(tmp_path / "r.json"))
    saved = json.loads((tmp_path / "r.json").read_text())
    assert saved["a"]["count"] == 1 and set(saved["a"]) == {
        "count", "total_s", "mean_s", "last_s"}


def test_phase_records_on_error():
    with pytest.raises(ValueError):
        with profiling.phase("broken"):
            raise ValueError("x")
    assert profiling.phase_report()["broken"]["count"] == 1


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.span("my_range"):        # the recorder off: a range
            (x @ x).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "my_range" in names
    assert any("mm" in (n or "") for n in names)
    assert prof.key_averages() is not None
    kernels, all_events = profiling.kernel_events(str(tmp_path / "t" / "trace.json"))
    assert kernels == [] and len(all_events) == len(events)     # no card here


def test_device_sync_without_a_card_returns():
    assert profiling.device_sync(torch.zeros(2)) is None
    assert profiling.device_sync({"a": [torch.zeros(1)]}) is None


def test_device_split_and_busy_share():
    """Three kernels on a hand-made timeline (microseconds): two overlap,
    one after a gap; classes by the first matching name fragment."""
    kernels = [{"name": "flash_fwd_kernel<64>", "ts": 0.0, "dur": 100.0},
               {"name": "ampere_gemm", "ts": 50.0, "dur": 100.0},
               {"name": "elementwise_add", "ts": 300.0, "dur": 100.0}]
    classes = (("flash_fwd_kernel", "flash"), ("gemm", "matmul"))
    busy_ms, span_ms = profiling.busy(kernels)
    assert (busy_ms, span_ms) == (0.25, 0.4)
    split = profiling.device_split(kernels, classes)
    assert split["by_layer"] == {"flash": 0.1, "matmul": 0.1, "other": 0.1}
    assert split["kernels"] == 3 and split["busy_share"] == 0.25 / 0.4
    assert split["kernel_ms"] == pytest.approx(0.3)
    assert split["by_name"]["ampere_gemm"] == 0.1
