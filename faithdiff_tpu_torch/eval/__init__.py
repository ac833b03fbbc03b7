"""IQA metrics, VQA benchmarks, and review harnesses (counterpart of
`faithdiff_tpu/eval/`).

All 10 metrics of the reference protocol (`test_metrics.py`) run in the
port; the learned ones are weights-gated (their `make_*` factory returns
None without a converted checkpoint and the harness reports an explicit
UNAVAILABLE). The factories run their networks on the CUDA card unless
given `device="cpu"`."""
from .metrics import REFERENCE_METRICS, evaluate_dirs, psnr, ssim  # noqa: F401


def __getattr__(name):
    # lazy factories: a metric module is imported only when asked for
    factories = {
        "make_lpips": ("lpips", "make_lpips"),
        "make_dists": ("dists", "make_dists"),
        "make_niqe_metric": ("niqe", "make_niqe_metric"),
        "make_fid_features": ("fid", "make_fid_features"),
        "make_clipiqa": ("clipiqa", "make_clipiqa"),
        "make_musiq": ("musiq", "make_musiq"),
        "make_maniqa": ("maniqa", "make_maniqa"),
        "make_paq2piq": ("paq2piq", "make_paq2piq"),
    }
    if name in factories:
        import importlib

        mod, attr = factories[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(name)
