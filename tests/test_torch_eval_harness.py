"""The port's `metrics` command (`faithdiff_tpu_torch/eval/metrics.py`,
served by `cli.main(["metrics", ...])`) against the JAX harness on the
CPU, with weight files for every learned metric written in the JAX layout:
LPIPS (AlexNet), DISTS, PaQ-2-PiQ, and MUSIQ, MANIQA and CLIPIQA at the JAX
tests' tiny configs, plus NIQE's pristine parameters fitted by each side's
`--fit_niqe_dir` (equal within 1e-9). Two SR images and their GTs, one GT
at another size (the harness's BICUBIC resize of the truncated uint8).

Held: the `[metric]` availability lines byte for byte (MANIQA's caveat
included), the per-image lines' keys in order and values within
2e-4 * (1 + |ref|) (1e-4 for the networks plus the print's rounding), the
MEAN and UNAVAILABLE lines, and the final JSON: the same keys, PSNR and
SSIM within 1e-5, the learned scores within 1e-4 * (1 + |ref|). The
measured `runtime_s` is compared by key only. FID runs without weights
here (both sides print its UNAVAILABLE line): scipy's sqrtm of the
2048-d covariance product takes ~20 s of CPU a side; FID's features and
Frechet step are held in `test_torch_eval_iqa_nets.py`."""
import json
import re

import jax
import numpy as np
import pytest
import torch

from faithdiff_tpu.eval import clipiqa as jclip
from faithdiff_tpu.eval import lpips as jlpips
from faithdiff_tpu.eval import maniqa as jmaniqa
from faithdiff_tpu.eval import metrics as jmetrics
from faithdiff_tpu.eval import musiq as jmusiq
from faithdiff_tpu.eval import paq2piq as jpaq
from faithdiff_tpu.eval import dists as jdists
from faithdiff_tpu_torch import cli
from faithdiff_tpu_torch.eval import metrics as tmetrics
from faithdiff_tpu_torch.eval import make_lpips, make_musiq
from faithdiff_tpu_torch.utils.png import write_png
from test_clipiqa import _our_configs
from test_maniqa import CFG as MANIQA_CFG
from test_maniqa import TorchMANIQA
from test_musiq import CFG as MUSIQ_CFG
from test_musiq import TorchMUSIQ
from test_paq2piq import TorchRoIPoolModel, _randomize_bn_stats
from test_torch_eval_iqa_nets import (_ALEX_CH, _ALEX_IDX, _VGG_CH, _VGG_IDX,
                                      _vgg_like_sd, clip_model_state_dict)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Every learned metric's file, written by the JAX package's writers
    from upstream torch layouts (the port's writers are held to these
    layouts in `test_torch_eval_iqa_nets.py`)."""
    d = tmp_path_factory.mktemp("weights")
    rng = np.random.default_rng(5)
    lin = {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1)).astype(np.float32)
           for i, (c, _) in enumerate(_ALEX_CH)}
    jlpips.save_lpips_params(jlpips.convert_lpips(
        _vgg_like_sd(_ALEX_IDX, _ALEX_CH, 1), lin), str(d / "lpips.npz"))
    sd = _vgg_like_sd(_VGG_IDX, _VGG_CH, 2)
    sd["alpha"] = rng.random((1, 1475, 1, 1)).astype(np.float32)
    sd["beta"] = rng.random((1, 1475, 1, 1)).astype(np.float32)
    jlpips.save_lpips_params(jdists.convert_dists(sd), str(d / "dists.npz"))
    torch.manual_seed(0)
    paq = TorchRoIPoolModel().eval()
    with torch.no_grad():
        _randomize_bn_stats(paq, np.random.default_rng(7))
    jlpips.save_lpips_params(jpaq.convert_paq2piq(
        {k: v.numpy() for k, v in paq.state_dict().items()}), str(d / "paq.npz"))
    jmusiq.save_musiq_weights(jmusiq.convert_musiq(
        {k: v.detach().numpy() for k, v in TorchMUSIQ(MUSIQ_CFG).state_dict().items()},
        MUSIQ_CFG), str(d / "musiq.npz"), MUSIQ_CFG)
    jmaniqa.save_maniqa_weights(jmaniqa.convert_maniqa(
        {k: v.detach().numpy() for k, v in TorchMANIQA(MANIQA_CFG).state_dict().items()},
        MANIQA_CFG), str(d / "maniqa.npz"), MANIQA_CFG)
    vision, text = _our_configs()
    ids = np.asarray([[1, 5, 6, 7, 99, 0, 0, 0], [1, 5, 8, 99, 0, 0, 0, 0]], np.int32)
    jclip.save_clipiqa_weights(
        jclip.convert_clip_model(clip_model_state_dict(1)),
        str(d / "clip.npz"), vision, text, eos_token_id=99, prompt_ids=ids)
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(9)
    for sub in ("sr", "gt", "pristine"):
        (d / sub).mkdir()
    for i, (h, w, gh, gw) in enumerate([(192, 200, 192, 200), (200, 192, 150, 170)]):
        sr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        write_png(str(d / "sr" / f"img{i}.png"), sr)
        gt = np.clip(sr[:gh, :gw].astype(int) + rng.integers(-20, 20, (gh, gw, 3)),
                     0, 255).astype(np.uint8)
        write_png(str(d / "gt" / f"img{i}.png"), gt)
    for i in range(2):
        write_png(str(d / "pristine" / f"p{i}.png"),
                  rng.integers(0, 256, (200, 210, 3), dtype=np.uint8))
    return d


def _parse(out):
    """stdout -> (availability lines, {image: [(key, value)]}, MEAN pairs,
    UNAVAILABLE summary lines, the JSON)."""
    lines = out.strip().split("\n")
    avail = [line for line in lines if line.startswith("[metric]")]
    rows, mean, tail = {}, None, []
    for line in lines:
        m = re.match(r"^(img\d\.png): (.*)$", line)
        if m:
            rows[m.group(1)] = [tuple(kv.split("=")) for kv in m.group(2).split()]
        elif line.startswith("MEAN: "):
            mean = [tuple(kv.split("=")) for kv in line[6:].split()]
        elif re.match(r"^[a-z0-9+_-]+: UNAVAILABLE", line):
            tail.append(line)
    return avail, rows, mean, tail, json.loads(lines[-1])


def _close_pairs(ours, want, atol):
    assert [k for k, _ in ours] == [k for k, _ in want]
    for (k, a), (_, b) in zip(ours, want):
        if k != "runtime_s":
            np.testing.assert_allclose(float(a), float(b), rtol=atol, atol=atol,
                                       err_msg=k)


def test_metrics_command_matches_jax(weights, dirs, tmp_path, capsys):
    niqe = {}
    for side, main in (("t", lambda a: cli.main(["metrics"] + a + ["--device", "cpu"])),
                       ("j", jmetrics.main)):
        niqe[side] = str(tmp_path / f"niqe_{side}.npz")
        main(["--fit_niqe_dir", str(dirs / "pristine"), "--niqe_params", niqe[side]])
    ours_p, want_p = np.load(niqe["t"]), np.load(niqe["j"])
    for k in ("mu", "cov", "patch_size"):
        np.testing.assert_allclose(ours_p[k], want_p[k], rtol=1e-9, atol=1e-12)
    capsys.readouterr()
    w = weights
    argv = ["--sr_dir", str(dirs / "sr"), "--gt_dir", str(dirs / "gt"),
            "--niqe_params", niqe["j"], "--lpips_weights", str(w / "lpips.npz"),
            "--dists_weights", str(w / "dists.npz"), "--paq2piq_weights", str(w / "paq.npz"),
            "--musiq_weights", str(w / "musiq.npz"), "--maniqa_weights", str(w / "maniqa.npz"),
            "--clipiqa_weights", str(w / "clip.npz"),
            "--fid_weights", str(tmp_path / "absent.npz")]
    assert cli.main(["metrics"] + argv + ["--device", "cpu",
                                          "--log", str(tmp_path / "t.log")]) == 0
    ours = _parse(capsys.readouterr().out)
    jmetrics.main(argv + ["--log", str(tmp_path / "j.log")])
    want = _parse(capsys.readouterr().out)
    assert ours[0] == want[0] and len(ours[0]) == 10
    assert sum("native" in line for line in ours[0]) == 9
    assert ours[1].keys() == want[1].keys() == {"img0.png", "img1.png"}
    for name in ours[1]:
        _close_pairs(ours[1][name], want[1][name], 2e-4)
    _close_pairs(ours[2], want[2], 2e-4)
    assert ours[3] == want[3] == [
        "fid: UNAVAILABLE: no InceptionV3 weights (eval/inception_v3_fid.npz or .pth)"]
    got, ref = ours[4], want[4]
    assert got.keys() == ref.keys()
    assert got.pop("_unavailable") == ref.pop("_unavailable")
    got.pop("runtime_s"), ref.pop("runtime_s")
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got.pop(k), ref.pop(k), rtol=1e-5, atol=1e-5)
    assert set(got) == {"lpips", "dists", "niqe", "musiq", "maniqa-pipal",
                        "clipiqa+_vitL14_512", "paq2piq"}
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    # the log holds the per-image and summary lines
    assert open(tmp_path / "t.log").read().count("\n") == 4


@pytest.mark.parametrize("has_gt", [True, False])
def test_metric_availability_lines_equal_jax(has_gt):
    names = ("niqe_fn", "fid_fn", "lpips_fn", "dists_fn", "clipiqa_fn", "musiq_fn",
             "paq2piq_fn", "maniqa_fn")
    for mask in range(0, 256, 37):
        kw = {n: (object() if mask >> i & 1 else None) for i, n in enumerate(names)}
        for learned in ({}, {"musiq": None, "lpips": None}):
            assert tmetrics.metric_availability(learned, has_gt=has_gt, **kw) == \
                jmetrics.metric_availability(learned, has_gt=has_gt, **kw)


def test_harness_refuses_jpeg_and_gates_device(dirs, tmp_path):
    jpg = tmp_path / "sr"
    jpg.mkdir()
    (jpg / "a.png").write_bytes((dirs / "sr" / "img0.png").read_bytes())
    (jpg / "b.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match=r"b\.jpg: truncated JPEG"):
        tmetrics.evaluate_dirs(str(jpg), device="cpu")
    assert tmetrics.make_learned_metrics() == jmetrics.make_learned_metrics() == {}
    assert make_lpips(str(tmp_path / "none.npz"), device="cpu") is None
    assert make_musiq(str(tmp_path / "none.npz"), device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_lpips(str(tmp_path / "none.npz"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmetrics.evaluate_dirs(str(dirs / "sr"))
    assert jax.devices()[0].platform == "cpu"
