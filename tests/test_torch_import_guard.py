"""The PyTorch port imports nothing of JAX, flax or the JAX package, and
none of PIL, transformers, regex, ftfy, safetensors, orbax, OpenCV,
protobuf or sentencepiece (the card's machine has none of them): every
module of `faithdiff_tpu_torch` and `chip_smoke.py`, read as source, and
the package as imported in a fresh interpreter."""
import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "faithdiff_tpu", "PIL",
             "transformers", "regex", "ftfy", "safetensors", "orbax", "cv2",
             "google", "protobuf", "sentencepiece", "msgpack")
# imported only inside the function that uses it, never at import time: the
# JAX harness's optional pyiqa passthrough (`eval/metrics.make_learned_metrics`)
OPTIONAL = ("pyiqa",)
SERVING_MODULES = ("chat", "controller", "external_worker", "web_demo", "worker")
PARALLEL_MODULES = ("distributed", "mesh", "tp")
EVAL_MODULES = ("clipiqa", "dists", "drivers", "fid", "generators", "gpt_review",
                "lpips", "maniqa", "metrics", "musiq", "niqe", "paq2piq",
                "scorers", "vqa", "vqa_protocol")


def _port_sources():
    files = sorted((ROOT / "faithdiff_tpu_torch").rglob("*.py"))
    assert len(files) >= 66, files
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_of_the_port_imports_jax():
    bad = [(str(p.relative_to(ROOT)), name) for p in _port_sources()
           for name in _imported_roots(p) if name in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    # the interpreter may load a namespace package at start-up (a `.pth`
    # file of an installed `google-*` distribution): only what the imports
    # below add counts
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import faithdiff_tpu_torch, faithdiff_tpu_torch.pipelines, "
        "faithdiff_tpu_torch.models, faithdiff_tpu_torch.ops.attention, "
        "faithdiff_tpu_torch.ops.groupnorm, faithdiff_tpu_torch.utils.convert, "
        "faithdiff_tpu_torch.utils.color_fix, faithdiff_tpu_torch.captioner, "
        "faithdiff_tpu_torch.captioner.mpt, faithdiff_tpu_torch.ops.nf4_matmul, "
        "faithdiff_tpu_torch.utils.quantize, "
        "faithdiff_tpu_torch.models.transformer2d, "
        "faithdiff_tpu_torch.ops.attention_variants, "
        "faithdiff_tpu_torch.scripts.bench_attention_variants, "
        "faithdiff_tpu_torch.cli, faithdiff_tpu_torch.utils.convert_cli, "
        "faithdiff_tpu_torch.utils.png, faithdiff_tpu_torch.utils.image, "
        "faithdiff_tpu_torch.models.clip_text, "
        "faithdiff_tpu_torch.models.tokenizer, "
        "faithdiff_tpu_torch.training.text_embeds, "
        "faithdiff_tpu_torch.training.lora, "
        "faithdiff_tpu_torch.captioner.llama_tokenizer, "
        "faithdiff_tpu_torch.models.bsrnet, faithdiff_tpu_torch.ops.autograd, "
        "faithdiff_tpu_torch.training.train, faithdiff_tpu_torch.training.ema, "
        "faithdiff_tpu_torch.training.checkpoint, "
        "faithdiff_tpu_torch.training.logging, "
        "faithdiff_tpu_torch.training.losses, "
        "faithdiff_tpu_torch.training.runner, faithdiff_tpu_torch.data, "
        "faithdiff_tpu_torch.data.dataset, faithdiff_tpu_torch.data.prefetch, "
        "faithdiff_tpu_torch.data.jpeg, faithdiff_tpu_torch.data.degradation, "
        "faithdiff_tpu_torch.schedulers.ddim, "
        "faithdiff_tpu_torch.training.caption_data, "
        "faithdiff_tpu_torch.training.caption_train, faithdiff_tpu_torch.eval, "
        "faithdiff_tpu_torch.utils.profiling, faithdiff_tpu_torch.serving, "
        "faithdiff_tpu_torch.parallel, faithdiff_tpu_torch.utils.jpeg, "
        "faithdiff_tpu_torch.native\n"
        + "".join(f"import faithdiff_tpu_torch.serving.{m}\n" for m in SERVING_MODULES)
        + "".join(f"import faithdiff_tpu_torch.parallel.{m}\n" for m in PARALLEL_MODULES)
        + "".join(f"import faithdiff_tpu_torch.eval.{m}\n" for m in EVAL_MODULES) +
        "import chip_smoke\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        f"{FORBIDDEN + OPTIONAL!r})\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_jax_module_has_a_counterpart():
    """Each module of the JAX package has one at the same path in the
    port (`native.py` was the last, over the port's own host library)."""
    jax_modules = {p.relative_to(ROOT / "faithdiff_tpu")
                   for p in (ROOT / "faithdiff_tpu").rglob("*.py")}
    ours = {p.relative_to(ROOT / "faithdiff_tpu_torch")
            for p in (ROOT / "faithdiff_tpu_torch").rglob("*.py")}
    assert sorted(map(str, jax_modules - ours)) == []


def test_eval_port_is_complete_and_imports_pyiqa_only_where_used():
    """One port module for each module of the JAX package's `eval/`, and
    `pyiqa` imported in no module's top level (the passthrough imports it
    inside `make_learned_metrics`, as JAX does)."""
    jax_eval = {p.stem for p in (ROOT / "faithdiff_tpu" / "eval").glob("*.py")}
    ours = {p.stem for p in (ROOT / "faithdiff_tpu_torch" / "eval").glob("*.py")}
    assert ours == jax_eval == set(EVAL_MODULES) | {"__init__"}
    for m in EVAL_MODULES:
        tree = ast.parse((ROOT / "faithdiff_tpu_torch" / "eval" / f"{m}.py").read_text())
        top = [a.name for node in tree.body if isinstance(node, ast.Import)
               for a in node.names]
        top += [node.module for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.module]
        assert not [t for t in top if t.split(".")[0] in OPTIONAL], m


def test_serving_and_parallel_ports_are_complete():
    """One port module for each module of the JAX package's `serving/` and
    `parallel/`, and the port's `utils/profiling.py`."""
    for pkg, names in (("serving", SERVING_MODULES), ("parallel", PARALLEL_MODULES)):
        jax_side = {p.stem for p in (ROOT / "faithdiff_tpu" / pkg).glob("*.py")}
        ours = {p.stem for p in (ROOT / "faithdiff_tpu_torch" / pkg).glob("*.py")}
        assert ours == jax_side == set(names) | {"__init__"}, pkg
    assert (ROOT / "faithdiff_tpu_torch" / "utils" / "profiling.py").exists()


def _non_docstring_strings(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.lineno, node.value


def test_no_file_of_the_port_opens_a_path_under_the_jax_package():
    """No string of the port (docstrings aside) is a path into
    `faithdiff_tpu/`: neither the directory as a path component nor a file
    under it, other than a `file.py:line` label naming a TPU kernel; and
    the eval modules' default weight files and review rules lie in the
    port's own `eval/`."""
    import re

    label = re.compile(r"^faithdiff_tpu/[\w/]+\.py:\d+")
    bad = [(str(p.relative_to(ROOT)), line, s) for p in _port_sources()
           for line, s in _non_docstring_strings(p)
           if s == "faithdiff_tpu" or ("faithdiff_tpu/" in s and not label.match(s))]
    assert bad == []
    import importlib

    here = ROOT / "faithdiff_tpu_torch" / "eval"
    paths = []
    for m in ("lpips", "dists", "fid", "paq2piq", "musiq", "maniqa", "clipiqa", "niqe"):
        mod = importlib.import_module(f"faithdiff_tpu_torch.eval.{m}")
        for name in ("_DEFAULT_WEIGHTS", "DEFAULT_WEIGHTS_PATH", "DEFAULT_PARAMS_PATH"):
            v = getattr(mod, name, None)
            paths += list(v.values()) if isinstance(v, dict) else [v] if v else []
    assert len(paths) == 9
    assert all(pathlib.Path(p).parent == here for p in paths), paths
    from faithdiff_tpu_torch.eval import gpt_review

    assert gpt_review.DEFAULT_RULES == json.loads((here / "review_rules.json").read_text())
