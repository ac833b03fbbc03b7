"""The port's Real-ESRGAN degradation engine and DiffJPEG
(`data/degradation.py`, `data/jpeg.py`) against the JAX package's at
1e-5, fp32 on the CPU: the host kernel synthesis (same numpy seed, same
kernels), `filter2d`, `resize` in its three modes up and down at odd
sizes (`jax.image.resize`'s weights), each noise op given the draws JAX
makes from its key, the colour ops, `jpeg_compress`, and
`RealESRGANDegradation` end to end on the same seed and draws over plans
that together take every branch. The port's draws are rebuilt from the
JAX engine's key splits (`jax.random.split(key, 8)`, then each op's own
`split(k, 3)`), so both sides add the same noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.data import degradation as jd
from faithdiff_tpu.data import jpeg as jj
from faithdiff_tpu_torch.data import degradation as td
from faithdiff_tpu_torch.data import jpeg as tj

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


class JaxDraws:
    """The JAX engine's draws for `key`: keys[0] / [1] / [2] stage 1's
    Gaussian, Poisson and JPEG quality, keys[3] / [4] / [5] stage 2's."""

    def __init__(self, key):
        self.keys = jax.random.split(key, 8)

    def gaussian(self, stage, shape, sigma_range, gray_prob):
        k1, k2, k3 = jax.random.split(self.keys[3 * stage], 3)
        b = shape[0]
        sigma = jax.random.uniform(k1, (b, 1, 1, 1), minval=sigma_range[0],
                                   maxval=sigma_range[1]) / 255.0
        gray = jax.random.uniform(k2, (b, 1, 1, 1)) < gray_prob
        noise = jax.random.normal(k3, tuple(shape), jnp.float32)
        return _t(sigma).reshape(-1), _t(gray).reshape(-1), _t(noise)

    def poisson(self, stage, image, scale_range, gray_prob):
        k1, k2, k3 = jax.random.split(self.keys[3 * stage + 1], 3)
        b = image.shape[0]
        img = jnp.asarray(image.numpy())
        scale = jax.random.uniform(k1, (b, 1, 1, 1), minval=scale_range[0],
                                   maxval=scale_range[1])
        gray = jax.random.uniform(k2, (b, 1, 1, 1)) < gray_prob
        counts = jax.random.poisson(k3, jnp.clip(img, 0, 1) * 256.0)
        counts_gray = jax.random.poisson(
            k3, jnp.clip(jnp.mean(img, -1, keepdims=True), 0, 1) * 256.0)
        return (_t(scale).reshape(-1), _t(gray).reshape(-1),
                _t(counts.astype(jnp.float32)), _t(counts_gray.astype(jnp.float32)))

    def jpeg_quality(self, stage, b, lo, hi):
        return _t(jax.random.uniform(self.keys[3 * stage + 2], (b,), minval=lo,
                                     maxval=hi))


def test_kernel_synthesis_same_seed_same_kernels():
    for name, args in [("bivariate_gaussian", (21, 1.3, 0.7, 0.4, None, False)),
                       ("bivariate_gaussian", (15, 2.0)),
                       ("bivariate_generalized_gaussian", (21, 1.1, 2.2, -0.3, 1.5, False)),
                       ("bivariate_plateau", (13, 1.4, 0.9, 1.0, 1.3, False)),
                       ("circular_lowpass_kernel", (1.7, 11, 21))]:
        np.testing.assert_array_equal(getattr(td, name)(*args),
                                      getattr(jd, name)(*args))
    for cfg in (jd.KernelConfig(), jd.KernelConfig(blur_sigma=(0.2, 1.5), sinc_prob=0.5)):
        rj, rt = np.random.default_rng(5), np.random.default_rng(5)
        tcfg = td.KernelConfig(**dataclasses.asdict(cfg))
        for _ in range(40):
            np.testing.assert_array_equal(td.sample_degradation_kernel(rt, tcfg),
                                          jd.sample_degradation_kernel(rj, cfg))
            np.testing.assert_array_equal(td.sample_final_sinc_kernel(rt),
                                          jd.sample_final_sinc_kernel(rj))


@pytest.mark.parametrize("hw", [(23, 29), (12, 40)])
def test_filter2d(hw):
    img = _img(0, (2,) + hw + (3,))
    rng = np.random.default_rng(1)
    kern = np.stack([jd.sample_degradation_kernel(rng, jd.KernelConfig())
                     for _ in range(2)])
    want = jd.filter2d(jnp.asarray(img), jnp.asarray(kern))
    got = td.filter2d(_t(img), _t(kern))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["area", "bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(37, 11), (9, 50), (23, 8), (5, 29)],
                         ids=str)
def test_resize_is_jax_image_resize(mode, size):
    img = _img(2, (2, 23, 29, 3))
    want = jd.resize(jnp.asarray(img), size, mode)
    got = td.resize(_t(img), size, mode)
    assert got.shape == (2,) + size + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gray_prob", [0.0, 0.5, 1.0])
def test_noise_ops_with_jax_draws(gray_prob):
    img = _img(3, (4, 17, 19, 3))
    key = jax.random.PRNGKey(7)
    draws = JaxDraws(key)
    want = jd.add_gaussian_noise(draws.keys[0], jnp.asarray(img), (1, 15), gray_prob)
    got = td.add_gaussian_noise(_t(img), *draws.gaussian(0, img.shape, (1, 15),
                                                         gray_prob))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jd.add_poisson_noise(draws.keys[4], jnp.asarray(img), (0.05, 2.0), gray_prob)
    got = td.add_poisson_noise(_t(img), *draws.poisson(1, _t(img), (0.05, 2.0),
                                                       gray_prob))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_torch_draws_are_seeded():
    img = _t(_img(3, (2, 9, 11, 3)))
    a = td.TorchDraws(torch.Generator().manual_seed(3))
    b = td.TorchDraws(torch.Generator().manual_seed(3))
    for x, y in zip(a.poisson(0, img, (0.05, 2.0), 0.4),
                    b.poisson(0, img, (0.05, 2.0), 0.4)):
        assert torch.equal(x, y)
    sigma, gray, noise = a.gaussian(0, img.shape, (1, 15), 0.4)
    assert sigma.shape == gray.shape == (2,) and noise.shape == img.shape
    assert ((sigma >= 1 / 255) & (sigma <= 15 / 255)).all()


def test_color_ops():
    img = _img(4, (2, 13, 15, 3))
    j, t = jnp.asarray(img), _t(img)
    for name, arg in [("adjust_brightness", 1.3), ("adjust_contrast", 0.6),
                      ("adjust_saturation", 1.4), ("adjust_hue", 0.07),
                      ("adjust_hue", -0.1)]:
        np.testing.assert_allclose(getattr(td, name)(t, arg).numpy(),
                                   np.asarray(getattr(jd, name)(j, arg)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(td.rgb_to_grayscale(t).numpy(),
                               np.asarray(jd.rgb_to_grayscale(j)), **TOL)
    got = td.color_jitter(t, np.random.default_rng(9))
    want = jd.color_jitter(j, np.random.default_rng(9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_jpeg_compress_and_pad():
    img = _img(5, (3, 21, 35, 3))
    padded_j, h, w = jj.pad_to_16(jnp.asarray(img))
    padded_t, h2, w2 = tj.pad_to_16(_t(img))
    assert (h, w) == (h2, w2) and padded_t.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(padded_t.numpy(), np.asarray(padded_j))
    q = np.array([10.0, 50.0, 93.7], np.float32)
    want = jj.jpeg_compress(padded_j, jnp.asarray(q))
    got = tj.jpeg_compress(padded_t, _t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tj.quality_to_factor(_t(q)).numpy(),
                               np.asarray(jj.quality_to_factor(q)), rtol=1e-7)


# (config overrides, seed): together every branch (the trace test below
# asserts it)
PLANS = [
    (dict(gaussian_noise_prob=1.0, gaussian_noise_prob2=0.0,
          second_blur_prob=1.0), 3),
    (dict(gaussian_noise_prob=0.0, gaussian_noise_prob2=1.0,
          second_blur_prob=0.0, gray_prob=1.0, color_jitter_prob=1.0), 1),
]


def _trace(monkeypatch):
    """What the port's engine runs, by name."""
    seen = []
    for name in ("add_gaussian_noise", "add_poisson_noise", "rgb_to_grayscale",
                 "color_jitter", "jpeg_compress", "filter2d"):
        fn = getattr(td, name)
        monkeypatch.setattr(td, name, lambda *a, _n=name, _f=fn, **k:
                            (seen.append(_n), _f(*a, **k))[1])
    fn = td.resize
    monkeypatch.setattr(td, "resize", lambda img, size, mode:
                        (seen.append(mode), fn(img, size, mode))[1])
    return seen


def _configs(plan):
    over, seed = PLANS[plan]
    jcfg = dataclasses.replace(jd.DegradationConfig(), **over)
    tcfg = td.DegradationConfig(**{
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)},
        "kernel1": td.KernelConfig(**dataclasses.asdict(jcfg.kernel1)),
        "kernel2": td.KernelConfig(**dataclasses.asdict(jcfg.kernel2))})
    return jcfg, tcfg, seed


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_realesrgan_degradation_end_to_end(plan):
    jcfg, tcfg, seed = _configs(plan)
    gt = _img(10 + plan, (2, 64, 80, 3))
    key = jax.random.PRNGKey(100 + plan)
    _, want = jd.RealESRGANDegradation(jcfg, seed=seed)(key, jnp.asarray(gt))
    gt_t, got = td.RealESRGANDegradation(tcfg, seed=seed)(_t(gt), draws=JaxDraws(key))
    assert got.shape == (2, 16, 20, 3) and torch.equal(gt_t, _t(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plans_take_every_branch(monkeypatch):
    """The branches a plan takes follow from its seed and config alone
    (the host plan), so the port's engine with its own draws shows them."""
    seen = set()
    for plan in range(len(PLANS)):
        _, tcfg, seed = _configs(plan)
        trace = _trace(monkeypatch)
        td.RealESRGANDegradation(tcfg, seed=seed)(
            _t(_img(10 + plan, (2, 64, 80, 3))),
            generator=torch.Generator().manual_seed(plan))
        monkeypatch.undo()
        seen |= set(trace)
        # the final pair in either order: jpeg last, or filter2d last
        seen.add("jpeg_last" if trace[-1] == "jpeg_compress" else "sinc_last")
        seen.add("blur2" if trace.count("filter2d") == 3 else "no_blur2")
    assert seen >= {"add_gaussian_noise", "add_poisson_noise", "rgb_to_grayscale",
                    "color_jitter", "area", "bilinear", "bicubic", "jpeg_last",
                    "sinc_last", "blur2", "no_blur2"}, seen

