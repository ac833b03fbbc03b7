"""IQA metric harness (counterpart of `faithdiff_tpu/eval/metrics.py`).

The protocol of the reference's `test_metrics.py` (pyiqa-based):
- PSNR / SSIM in torch on the device
- NIQE on the host (eval/niqe.py; pristine params fit via --fit_niqe_dir)
- directory-level FID (eval/fid.py InceptionV3, weights-gated)
- LPIPS / DISTS (eval/{lpips,dists}.py, weights-gated)
- CLIPIQA (eval/clipiqa.py full CLIP dual tower, weights-gated)
- MUSIQ (eval/musiq.py multi-scale transformer, weights-gated)
- PaQ-2-PiQ (eval/paq2piq.py ResNet-18 RoIPoolModel, weights-gated)
- MANIQA (eval/maniqa.py ViT + TAB + Swin dual-branch, weights-gated)

Every learned metric also keeps the JAX harness's optional pyiqa
passthrough, used when that package is installed (`make_learned_metrics`).

Every metric of the reference protocol appears in the output either with a
value or an explicit `UNAVAILABLE: <reason>` line. Images are PNGs and
JPEGs read as Pillow's `convert("RGB")` reads them (`utils/png.read_rgb`);
a file whose header the decoders refuse is refused before any weights
load. The networks run on
`--device` (the CUDA card by default) in fp32 with TF32 off.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.png import check_image, read_rgb
from ..utils.resample import resize_bicubic
from .lpips import fp32_exact, resolve_device


# ---------------------------------------------------------------------------
# full-reference metrics
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def psnr(a, b, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over [H, W, C] or batched arrays (test_metrics uses pyiqa psnr)."""
    mse_ = (_f32(a) - _f32(b)).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse_, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a, b, data_range: float = 1.0) -> torch.Tensor:
    """SSIM (Wang et al. 2004): 11x11 Gaussian window (sigma 1.5), K1=.01,
    K2=.03, VALID, computed per RGB channel and averaged (the JAX
    harness's, not pyiqa's Y-channel SSIM). a, b: [H, W, C] in
    [0, data_range]."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a, b = _f32(a), _f32(b)
    c = a.shape[-1]
    win = torch.as_tensor(_gaussian_window(), device=a.device)
    win = win.expand(c, 1, *win.shape)

    def filt(x):
        with fp32_exact():
            return F.conv2d(x.permute(2, 0, 1)[None], win, groups=c)[0]

    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sa = filt(a * a) - mu_aa
    sb = filt(b * b) - mu_bb
    sab = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sab + c2)) / ((mu_aa + mu_bb + c1) * (sa + sb + c2))
    return s.mean()


def mse(a, b) -> torch.Tensor:
    return (_f32(a) - _f32(b)).square().mean()


# ---------------------------------------------------------------------------
# optional learned metrics via pyiqa/torch (reference parity path)
# ---------------------------------------------------------------------------

_LEARNED = ("lpips", "dists", "niqe", "musiq", "maniqa-pipal",
            "clipiqa+_vitL14_512", "paq2piq")


def make_learned_metrics(names=_LEARNED, device: str = "cpu") -> Dict[str, object]:
    """Returns {name: callable(img_hwc01[, ref_hwc01]) -> float} for each
    metric whose weights are available; silently skips the rest."""
    out: Dict[str, object] = {}
    try:
        import pyiqa  # noqa
    except ImportError:
        return out
    for name in names:
        try:
            m = pyiqa.create_metric(name, device=device)
        except Exception:
            continue

        def call(img, ref=None, _m=m):
            t = torch.from_numpy(np.asarray(img, np.float32)).permute(
                2, 0, 1)[None]
            if ref is not None:
                r = torch.from_numpy(np.asarray(ref, np.float32)).permute(
                    2, 0, 1)[None]
                return float(_m(t, r))
            return float(_m(t))

        out[name] = call
    return out


# ---------------------------------------------------------------------------
# directory harness (test_metrics.py:127-141,195-227 protocol)
# ---------------------------------------------------------------------------

# every metric of the reference protocol (`test_metrics.py:127-141,195-227`)
# must be accounted for in the output: a value or an explicit UNAVAILABLE
REFERENCE_METRICS = ("psnr", "ssim", "lpips", "dists", "niqe", "musiq",
                     "maniqa-pipal", "clipiqa+_vitL14_512", "paq2piq", "fid")


def metric_availability(
    learned: Dict[str, object], niqe_fn, fid_fn, has_gt: bool,
    lpips_fn=None, dists_fn=None, clipiqa_fn=None, musiq_fn=None,
    paq2piq_fn=None, maniqa_fn=None,
) -> Dict[str, str]:
    """For each reference metric: 'native', 'pyiqa', or the reason it is
    unavailable. The harness NEVER silently drops a reference metric."""
    avail: Dict[str, str] = {}
    for m in REFERENCE_METRICS:
        if m in ("psnr", "ssim"):
            avail[m] = ("native" if has_gt
                        else "UNAVAILABLE: full-reference metric needs --gt_dir")
        elif m in learned:
            avail[m] = "pyiqa"
        elif m == "niqe":
            avail[m] = ("native" if niqe_fn is not None else
                        "UNAVAILABLE: no pristine params "
                        "(fit with --fit_niqe_dir or install pyiqa weights)")
        elif (m == "lpips" and lpips_fn is not None) or (
                m == "dists" and dists_fn is not None):
            avail[m] = ("native" if has_gt
                        else "UNAVAILABLE: full-reference metric needs --gt_dir")
        elif m == "clipiqa+_vitL14_512":
            avail[m] = ("native" if clipiqa_fn is not None else
                        "UNAVAILABLE: no CLIP weights (eval/clipiqa.npz with "
                        "_prompt_ids/_prompt_embeds, or --clipiqa_weights)")
        elif m == "musiq":
            avail[m] = ("native" if musiq_fn is not None else
                        "UNAVAILABLE: no MUSIQ weights (eval/musiq.npz or "
                        "--musiq_weights)")
        elif m == "paq2piq":
            avail[m] = ("native" if paq2piq_fn is not None else
                        "UNAVAILABLE: no PaQ-2-PiQ weights "
                        "(eval/paq2piq.npz or --paq2piq_weights)")
        elif m == "maniqa-pipal":
            # protocol caveat surfaced in the OUTPUT (not just the
            # docstring): our crops are a deterministic 5-crop, the
            # published MANIQA protocol averages 20 RANDOM crops, so
            # scores will not numerically match pyiqa on real images
            avail[m] = ("native (deterministic 5-crop; published protocol "
                        "is 20 random crops — not numerically comparable "
                        "to pyiqa)" if maniqa_fn is not None else
                        "UNAVAILABLE: no MANIQA weights (eval/maniqa.npz "
                        "or --maniqa_weights)")
        elif m == "fid":
            if fid_fn is None:
                avail[m] = ("UNAVAILABLE: no InceptionV3 weights "
                            "(eval/inception_v3_fid.npz or .pth)")
            elif not has_gt:
                avail[m] = "UNAVAILABLE: directory-level FID needs --gt_dir"
            else:
                avail[m] = "native"
        elif m in ("lpips", "dists"):
            avail[m] = (
                "UNAVAILABLE: full-reference metric needs --gt_dir"
                if not has_gt else
                f"UNAVAILABLE: no {m.upper()} weights (eval/{m}.npz or "
                f"--{m}_weights)")
        else:
            avail[m] = "UNAVAILABLE: needs pyiqa + pretrained weights"
    return avail


def _image_paths(d: str) -> List[str]:
    """The harness's images of `d` (PNG and JPEG names, sorted), each
    header checked (`utils/png.check_image`)."""
    paths = sorted(sum([glob.glob(os.path.join(d, e))
                        for e in ("*.png", "*.jpg", "*.jpeg")], []))
    for path in paths:
        check_image(path)
    return paths


def evaluate_dirs(
    sr_dir: str,
    gt_dir: Optional[str] = None,
    log_path: Optional[str] = None,
    use_learned: bool = True,
    niqe_params: Optional[str] = None,
    fid_weights: Optional[str] = None,
    lpips_weights: Optional[str] = None,
    dists_weights: Optional[str] = None,
    clipiqa_weights: Optional[str] = None,
    musiq_weights: Optional[str] = None,
    paq2piq_weights: Optional[str] = None,
    maniqa_weights: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    from .clipiqa import make_clipiqa
    from .dists import make_dists
    from .fid import fid_from_features, make_fid_features
    from .lpips import make_lpips
    from .maniqa import make_maniqa
    from .musiq import make_musiq
    from .niqe import make_niqe_metric
    from .paq2piq import make_paq2piq

    sr_paths = _image_paths(sr_dir)
    device = resolve_device(device, "metrics")
    learned = make_learned_metrics() if use_learned else {}
    niqe_fn = make_niqe_metric(niqe_params)
    fid_fn = make_fid_features(fid_weights, device=device)
    lpips_fn = make_lpips(lpips_weights, device=device)
    dists_fn = make_dists(dists_weights, device=device)
    clipiqa_fn = make_clipiqa(clipiqa_weights, device=device)
    musiq_fn = make_musiq(musiq_weights, device=device)
    paq2piq_fn = make_paq2piq(paq2piq_weights, device=device)
    maniqa_fn = make_maniqa(maniqa_weights, device=device)
    avail = metric_availability(learned, niqe_fn, fid_fn, gt_dir is not None,
                                lpips_fn, dists_fn, clipiqa_fn, musiq_fn,
                                paq2piq_fn, maniqa_fn)
    for m, status in sorted(avail.items()):
        print(f"[metric] {m}: {status}")
    rows: List[Dict[str, float]] = []
    sr_images: List[np.ndarray] = []
    gt_images: List[np.ndarray] = []
    log_f = open(log_path, "w") if log_path else None
    for path in sr_paths:
        name = os.path.basename(path)
        sr = read_rgb(path).astype(np.float32) / 255.0
        row: Dict[str, float] = {}
        gt = None
        if gt_dir:
            gt_path = os.path.join(gt_dir, name)
            if os.path.exists(gt_path):
                gt = read_rgb(gt_path).astype(np.float32) / 255.0
                if gt.shape != sr.shape:
                    # Pillow's default resize filter (BICUBIC) after the
                    # JAX harness's truncation to uint8
                    gt = resize_bicubic(np.uint8(gt * 255),
                                        (sr.shape[1], sr.shape[0])
                                        ).astype(np.float32) / 255.0
                sr_t = torch.as_tensor(sr, device=device)
                gt_t = torch.as_tensor(gt, device=device)
                row["psnr"] = float(psnr(sr_t, gt_t))
                row["ssim"] = float(ssim(sr_t, gt_t))
        t0 = time.time()
        if niqe_fn is not None and "niqe" not in learned:
            try:
                row["niqe"] = niqe_fn(sr)
            except ValueError:
                pass  # image smaller than the NIQE patch
        if lpips_fn is not None and "lpips" not in learned and gt is not None:
            row["lpips"] = lpips_fn(sr, gt)
        if dists_fn is not None and "dists" not in learned and gt is not None:
            row["dists"] = dists_fn(sr, gt)
        if clipiqa_fn is not None and "clipiqa+_vitL14_512" not in learned:
            row["clipiqa+_vitL14_512"] = clipiqa_fn(sr)
        if musiq_fn is not None and "musiq" not in learned:
            row["musiq"] = musiq_fn(sr)
        if paq2piq_fn is not None and "paq2piq" not in learned:
            row["paq2piq"] = paq2piq_fn(sr)
        if maniqa_fn is not None and "maniqa-pipal" not in learned:
            row["maniqa-pipal"] = maniqa_fn(sr)
        for mname, fn in learned.items():
            try:
                needs_ref = mname in ("lpips", "dists")
                if needs_ref and gt is None:
                    continue
                row[mname] = fn(sr, gt) if needs_ref else fn(sr)
            except Exception:
                pass
        row["runtime_s"] = time.time() - t0
        if fid_fn is not None and gt is not None:
            sr_images.append(sr)
            gt_images.append(gt)
        rows.append(row)
        line = f"{name}: " + " ".join(f"{k}={v:.4f}" for k, v in row.items())
        print(line)
        if log_f:
            log_f.write(line + "\n")

    means = {}
    for k in {k for r in rows for k in r}:
        vals = [r[k] for r in rows if k in r]
        if vals:
            means[k] = float(np.mean(vals))
    # directory-level FID (`test_metrics.py:195-227`)
    if fid_fn is not None and sr_images and gt_images:
        means["fid"] = fid_from_features(fid_fn(sr_images), fid_fn(gt_images))
    summary = "MEAN: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
    unavailable = {m: s for m, s in avail.items() if s.startswith("UNAVAILABLE")}
    for m, s in sorted(unavailable.items()):
        summary += f"\n{m}: {s}"
    print(summary)
    if log_f:
        log_f.write(summary + "\n")
        log_f.close()
    means["_unavailable"] = unavailable
    return means


def main(argv=None):
    p = argparse.ArgumentParser("metrics")
    p.add_argument("--sr_dir", default=None,
                   help="required unless --fit_niqe_dir is given")
    p.add_argument("--gt_dir", default=None)
    p.add_argument("--log", default=None)
    p.add_argument("--no_learned", action="store_true")
    p.add_argument("--niqe_params", default=None,
                   help="pristine-corpus npz (see --fit_niqe_dir)")
    p.add_argument("--fid_weights", default=None,
                   help="converted InceptionV3 weights (npz or torch pth)")
    p.add_argument("--lpips_weights", default=None,
                   help="converted LPIPS weights npz (eval/lpips.py "
                        "convert_lpips)")
    p.add_argument("--dists_weights", default=None,
                   help="converted DISTS weights npz (eval/dists.py "
                        "convert_dists)")
    p.add_argument("--clipiqa_weights", default=None,
                   help="converted CLIP weights npz (eval/clipiqa.py "
                        "convert_clip_model; carry _prompt_ids or "
                        "_prompt_embeds in the npz)")
    p.add_argument("--musiq_weights", default=None,
                   help="converted MUSIQ weights npz (eval/musiq.py "
                        "convert_musiq + save_musiq_weights)")
    p.add_argument("--paq2piq_weights", default=None,
                   help="converted PaQ-2-PiQ RoIPoolModel npz "
                        "(eval/paq2piq.py convert_paq2piq)")
    p.add_argument("--maniqa_weights", default=None,
                   help="converted MANIQA npz (eval/maniqa.py "
                        "convert_maniqa + save_maniqa_weights)")
    p.add_argument("--fit_niqe_dir", default=None,
                   help="fit NIQE pristine params from this image dir, save "
                        "to --niqe_params, then exit")
    p.add_argument("--device", default="cuda",
                   help="torch device the metric networks run on")
    args = p.parse_args(argv)
    if args.fit_niqe_dir:
        from .niqe import DEFAULT_PARAMS_PATH, fit_niqe_params

        images = [read_rgb(p) for p in _image_paths(args.fit_niqe_dir)]
        out = args.niqe_params or DEFAULT_PARAMS_PATH
        fit_niqe_params(images, save_path=out)
        print(f"fitted NIQE pristine params from {len(images)} images -> {out}")
        return
    if not args.sr_dir:
        p.error("--sr_dir is required unless --fit_niqe_dir is given")
    means = evaluate_dirs(args.sr_dir, args.gt_dir, args.log,
                          use_learned=not args.no_learned,
                          niqe_params=args.niqe_params,
                          fid_weights=args.fid_weights,
                          lpips_weights=args.lpips_weights,
                          dists_weights=args.dists_weights,
                          clipiqa_weights=args.clipiqa_weights,
                          musiq_weights=args.musiq_weights,
                          paq2piq_weights=args.paq2piq_weights,
                          maniqa_weights=args.maniqa_weights,
                          device=args.device)
    print(json.dumps(means))
