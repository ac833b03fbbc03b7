"""The port's training runner and `cli.py train`
(`faithdiff_tpu_torch/training/runner.py`) against the JAX runner: flag
defaults, stage defaults and synthetic batches equal; then the CLI on
the tiny configs on the CPU: 3 micro-steps writing `metrics.jsonl` and
checkpoints, a resume that continues from the saved step and restarts
its data stream and noise generator from `--seed` (as the JAX runner
does), a validation strip, and the flags that raise."""
import functools
import os

import numpy as np
import pytest
import torch

from faithdiff_tpu.training import runner as jax_runner
from faithdiff_tpu_torch import cli
from faithdiff_tpu_torch.config import (tiny_denoise_encoder_config,
                                        tiny_unet_config, tiny_vae_config)
from faithdiff_tpu_torch.eval import musiq
from faithdiff_tpu_torch.eval.lpips import seeded_init_, tree_from_module
from faithdiff_tpu_torch.training import runner
from faithdiff_tpu_torch.training.logging import read_metrics
from faithdiff_tpu_torch.utils.png import read_png, write_png

# the flags the JAX runner reads but never defines, and the port's device
PORT_ONLY = {"text_encoder_dir", "tokenizer_dir", "device"}


def test_parse_args_defaults_match_jax():
    j = vars(jax_runner.parse_args(["--output_dir", "o"]))
    p = vars(runner.parse_args(["--output_dir", "o"]))
    assert set(p) - set(j) == PORT_ONLY and set(j) <= set(p)
    assert {k: p[k] for k in j} == j
    assert p["text_encoder_dir"] is None and p["tokenizer_dir"] is None
    assert p["device"] == "cuda"


@pytest.mark.parametrize("flags", [[], ["--stage", "2"],
                                   ["--stage", "2", "--train_batch_size", "5",
                                    "--grad_accum", "3", "--remat", "0"],
                                   ["--train_batch_size", "1", "--remat", "1"]])
def test_resolve_stage_defaults_match_jax(flags):
    j = jax_runner.parse_args(["--output_dir", "o"] + flags)
    p = runner.parse_args(["--output_dir", "o"] + flags)
    jax_runner.resolve_stage_defaults(j)
    runner.resolve_stage_defaults(p)
    keys = ("train_batch_size", "grad_accum", "remat")
    assert [getattr(p, k) for k in keys] == [getattr(j, k) for k in keys]


def test_synthetic_batches_match_jax():
    jb = jax_runner._synthetic_batches(3, 16, 64, 32, 7)
    pb = runner._synthetic_batches(3, 16, 64, 32, 7)
    for _ in range(3):
        a, b = next(jb), next(pb)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture
def tiny_cli(monkeypatch):
    """`cli.main(["train", ...])` on the tiny configs; records the batch
    and the generator state each micro-step starts from."""
    seen = []
    make = runner.make_train_step

    def recording_make(*a, **k):
        step = make(*a, **k)

        def run(state, batch, generator=None, draws=None):
            seen.append((batch["hr"].copy(), generator.get_state().clone()))
            return step(state, batch, generator, draws)
        return run

    monkeypatch.setattr(runner, "make_train_step", recording_make)
    monkeypatch.setattr(runner, "main", functools.partial(
        runner.main, unet_config=tiny_unet_config(),
        vae_config=tiny_vae_config(),
        denoise_encoder_config=tiny_denoise_encoder_config()))
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield seen
    torch.set_num_threads(before)


def _train(out, *flags):
    return cli.main(["train", "--output_dir", str(out), "--synthetic_data",
                     "--device", "cpu", "--dtype", "float32",
                     "--resolution", "32", "--train_batch_size", "1",
                     "--grad_accum", "2", "--checkpointing_steps", "2",
                     "--checkpoints_total_limit", "2", "--log_every", "1",
                     "--lr_warmup_steps", "0", "--prefetch_depth", "0",
                     *flags])


def test_cli_train_writes_metrics_checkpoints_and_resumes(tmp_path, tiny_cli,
                                                          capsys):
    assert _train(tmp_path, "--max_train_steps", "3") == 0
    rows = read_metrics(str(tmp_path / "logs"))
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["train_loss"]) and r["grad_norm"] > 0
               for r in rows)
    # orbax's rule: the first save, every 2nd step, the final forced save
    assert sorted(d for d in os.listdir(tmp_path) if d.isdigit()) == ["2", "3"]
    first_run = list(tiny_cli)
    tiny_cli.clear()

    assert _train(tmp_path, "--max_train_steps", "5",
                  "--resume_from_checkpoint", "1") == 0
    assert "resumed from step 3" in capsys.readouterr().out
    assert [r["step"] for r in read_metrics(str(tmp_path / "logs"))] == \
        [1, 2, 3, 4, 5]
    assert sorted(d for d in os.listdir(tmp_path) if d.isdigit()) == ["4", "5"]
    # the resumed run's first micro-step takes the stream's first batch
    # and the generator as seeded, as the JAX runner restarts them
    assert len(tiny_cli) == 2
    np.testing.assert_array_equal(tiny_cli[0][0], first_run[0][0])
    assert torch.equal(tiny_cli[0][1], first_run[0][1])


def test_cli_train_validation_strip(tmp_path, tiny_cli):
    val = tmp_path / "val"
    val.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(val / f"v{i}.png"),
                  rng.integers(0, 256, (20, 28, 3), dtype=np.uint8))
    out = tmp_path / "run"
    assert _train(out, "--max_train_steps", "1", "--val_dir", str(val),
                  "--validation_steps", "1") == 0
    strip = read_png(str(out / "validation" / "step_1.png"))
    assert strip.shape == (32, 64, 3)


def test_cli_train_validation_musiq_name(tmp_path, tiny_cli, monkeypatch, capsys):
    """With MUSIQ weights at the default path (a tiny MUSIQ npz here) the
    strip is named with its images' mean score, as the JAX runner names it,
    and the mean is the port's MUSIQ of the strip's images."""
    cfg = musiq.MUSIQConfig(patch_size=8, hidden_size=16, num_layers=1,
                            num_heads=2, mlp_dim=32, grid_size=4,
                            scale_longer_sides=(24, 16), max_tokens=40)
    weights = tmp_path / "musiq.npz"
    model = seeded_init_(musiq.MUSIQ(cfg), 0)
    musiq.save_musiq_weights(tree_from_module(model), str(weights), cfg)
    monkeypatch.setattr(musiq, "_DEFAULT_WEIGHTS", str(weights))
    val = tmp_path / "val"
    val.mkdir()
    write_png(str(val / "v.png"),
              np.random.default_rng(1).integers(0, 256, (20, 28, 3), dtype=np.uint8))
    out = tmp_path / "run"
    assert _train(out, "--max_train_steps", "1", "--val_dir", str(val),
                  "--validation_steps", "1") == 0
    (name,) = os.listdir(out / "validation")
    strip = read_png(str(out / "validation" / name))
    mean = musiq.make_musiq(str(weights), device="cpu")(strip.astype(np.float32) / 255)
    assert name == f"step_1_musiq{mean:.3f}.png"
    assert f"validation MUSIQ @ step 1: {mean:.3f}" in capsys.readouterr().out


def test_refusals(tmp_path, monkeypatch):
    """What the runner refuses before anything is built. `--dtype float32`
    on the card and WORLD_SIZE > 1 are served: without a card the fp32 run
    meets only the missing card, and under WORLD_SIZE=4 a batch the ranks
    do not split, or ranks without a coordinator, are refused."""
    if not torch.cuda.is_available():
        for extra in ([], ["--dtype", "float32"]):
            with pytest.raises(RuntimeError, match="--device cpu"):
                runner.main(["--output_dir", str(tmp_path)] + extra)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="does not split over WORLD_SIZE=4"):
        runner.main(["--output_dir", str(tmp_path), "--device", "cpu",
                     "--train_batch_size", "6"])
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        runner.main(["--output_dir", str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)
