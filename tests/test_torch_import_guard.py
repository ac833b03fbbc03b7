"""The PyTorch port imports nothing of JAX, flax or the JAX package, and
none of PIL, transformers, regex, ftfy, safetensors, orbax, OpenCV,
protobuf or sentencepiece (the card's machine has none of them): every
module of `faithdiff_tpu_torch` and `chip_smoke.py`, read as source, and
the package as imported in a fresh interpreter."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "faithdiff_tpu", "PIL",
             "transformers", "regex", "ftfy", "safetensors", "orbax", "cv2",
             "google", "protobuf", "sentencepiece")


def _port_sources():
    files = sorted((ROOT / "faithdiff_tpu_torch").rglob("*.py"))
    assert len(files) >= 51, files
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
        "faithdiff_tpu_torch.models.bsrnet\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
