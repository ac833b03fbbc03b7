"""What the benchmark loads. Top-level module names (the part before the
first dot) are compared whole: `faithdiff_tpu_torch`, the port, is allowed,
though its name begins with the JAX package's, `faithdiff_tpu`."""
import ast
import os
import subprocess
import sys

import harness

BENCH = harness.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "faithdiff_tpu", "chip_smoke"}


def _imports(path):
    """Top-level names of every module that the file at `path` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for d, _, files in os.walk(top):
        if "tests" in os.path.relpath(d, BENCH).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_forbidden_names_are_compared_whole():
    mods = {"faithdiff_tpu_torch": 1, "faithdiff_tpu_torch.ops": 1, "jaxtyping": 1,
            "faithdiff_tpu.ops": 1, "jax.numpy": 1, "flax": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == ["faithdiff_tpu.ops", "flax", "jax.numpy"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        found = _imports(path) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"faithdiff_tpu_torch"}), (path, names)


def test_the_commands_modules_load_no_jax():
    """Load everything a run loads (the harness, the driver and the port's
    restore path under it, every metric reader, the control) in a fresh
    process and look at `sys.modules`."""
    code = f"""
import sys
sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}]
import harness, control, roofline, trace_reader, weights, generator
spec = harness.load_spec()
for w in spec["workloads"]:
    _, _, traffic, _ = harness.cell_inputs(spec, w["name"])
    harness.driver(traffic["driver"])
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.reader(m["name"])
import faithdiff_tpu_torch.cli, faithdiff_tpu_torch.pipelines
found = sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r}))
print("FOUND", found)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout, out.stdout
