"""The plain reference (`benchmark/reference/`) held against the port's
restore path at the tiny widths, in fp32 on the CPU, on the same seeded
weights and inputs. This test imports both; the reference imports nothing
of the port (`test_bench_imports.py`)."""
import dataclasses

import numpy as np
import pytest
import torch

import generator
import weights
from reference import models as ref_models
from reference import restore as ref_restore


def _port_config(cls, values):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items() if k in names})


def _port_models(cfg, device="cpu"):
    from faithdiff_tpu_torch.config import DenoiseEncoderConfig, UNetConfig, VAEConfig
    from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
    from faithdiff_tpu_torch.models.vae import AutoencoderKL, DenoiseEncoder

    with torch.device(device):
        return {"unet": UNet2DConditionModel(_port_config(UNetConfig, cfg["unet"])),
                "vae": AutoencoderKL(_port_config(VAEConfig, cfg["vae"])),
                "denoise_encoder": DenoiseEncoder(
                    _port_config(DenoiseEncoderConfig, cfg["denoise_encoder"]))}


@pytest.fixture(scope="module")
def tiny():
    import harness

    import os
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = harness.load_json(os.path.join(here, "tiny_config.json"))
    sds = weights.make_state_dicts(cfg, 20_251_018, "cpu", torch.float32)
    ref = ref_models.build_models(cfg)
    port = _port_models(cfg)
    for net in ref:
        ref[net].load_state_dict(sds[net], strict=True)
        port[net].load_state_dict(sds[net], strict=True)
        port[net].eval().requires_grad_(False)
    return cfg, ref, port


@pytest.mark.parametrize("config", ["faithdiff-sdxl-bf16", "faithdiff-sdxl-fp8"])
def test_state_dict_names_and_shapes_are_the_ports(config):
    """At the published widths the reference's tensors are the port's, name
    for name and shape for shape, so one state dict loads into both."""
    import harness

    cfg = harness.load_json(f"{harness.BENCH}/configs/{config}.json")
    ref = ref_models.build_models(cfg, "meta")
    port = _port_models(cfg, "meta")
    for net in ref:
        a = {k: tuple(v.shape) for k, v in ref[net].state_dict().items()}
        b = {k: tuple(v.shape) for k, v in port[net].state_dict().items()}
        assert a == b, net


def test_unet_call_matches_port(tiny):
    cfg, ref, port = tiny
    u = cfg["unet"]
    g = torch.Generator().manual_seed(3)
    b, k = 4, 32
    sample = torch.randn(b, 4, k, k, generator=g)
    ctx = torch.randn(b, 77, u["cross_attention_dim"], generator=g)
    pooled = torch.randn(b, 64, generator=g)
    ids = torch.tensor([[256, 384, 0, 16, 256, 384]] * b, dtype=torch.float32)
    lq = torch.randn(b, u["condition_channels"], k, k, generator=g)
    with torch.no_grad():
        want = port["unet"](sample, torch.tensor(801.0), ctx, pooled, ids, lq,
                            add_sample=True, fusion_group_size=2)
        got = ref["unet"](sample, 801.0, ctx, pooled, ids, lq, add_sample=True, group=2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_vae_and_denoise_encoder_match_port(tiny):
    cfg, ref, port = tiny
    g = torch.Generator().manual_seed(4)
    image = torch.rand(1, 3, 128, 192, generator=g) * 2 - 1
    z = torch.randn(1, 4, 16, 24, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(ref["vae"].encode_moments(image),
                                   port["vae"].encode_moments(image), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ref["vae"].decode(z), port["vae"].decode(z),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ref["denoise_encoder"](image),
                                   port["denoise_encoder"](image), rtol=1e-4, atol=1e-4)


def test_whole_restore_matches_port(tiny):
    """Latents of a whole 2-tile restore (denoise encoder, VAE encode and
    posterior draw, DDPM noise at t = 999, tiles, fusion UNet on both CFG
    halves, guidance, Euler, Gaussian merge) and its uint8 image (decode,
    wavelet fix)."""
    from faithdiff_tpu_torch.config import PipelineConfig, SchedulerConfig
    from faithdiff_tpu_torch.pipelines.faithdiff import FaithDiffPipeline
    from faithdiff_tpu_torch.schedulers import DDPMScheduler, EulerDiscreteScheduler

    cfg, ref, port = tiny
    pipe = FaithDiffPipeline(
        unet=port["unet"], vae=port["vae"], denoise_encoder=port["denoise_encoder"],
        scheduler=EulerDiscreteScheduler(_port_config(SchedulerConfig, cfg["scheduler"])),
        ddpm_scheduler=DDPMScheduler(_port_config(SchedulerConfig, cfg["scheduler"])),
        config=_port_config(PipelineConfig, cfg["pipeline"]),
        vae_scaling_factor=cfg["vae"]["scaling_factor"], tile_chunk=8)
    traffic = dict(height=256, width=384, photo_scale=2, prompt_tokens=77,
                   prompt_dim=64, pooled_dim=64, pool=1)
    r = generator.make_requests(traffic, 99, "cpu")[0]
    lat = pipe(r.image, r.prompt, r.pooled, r.neg_prompt, r.neg_pooled,
               seed=r.noise_seed, output_type="latent")
    img = pipe.decode(lat, r.image, output_type="uint8")
    src = torch.from_numpy(r.image)
    ref_lat = ref_restore.denoise(ref, cfg, src, r.prompt, r.pooled, r.neg_prompt,
                                  r.neg_pooled, r.noise_seed)
    assert float((lat - ref_lat).norm() / ref_lat.norm()) < 1e-4
    ref_img = ref_restore.decode(ref, cfg, lat, src).numpy()
    gap = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
    assert gap.max() <= 1 and gap.mean() < 1e-2


def test_fp8_rule_and_rounding_are_the_ports():
    """The reference picks the UNet tensors that the port stores in fp8 and
    rounds them to the same values, NaN past 464 included."""
    import harness
    from faithdiff_tpu_torch.utils.quantize import is_fp8_weight, to_fp8

    cfg = harness.load_json(f"{harness.BENCH}/configs/faithdiff-sdxl-fp8.json")
    unet = ref_models.build_models(cfg, "meta")["unet"]
    picked = 0
    for name, t in unet.state_dict().items():
        assert ref_restore.fp8_weight(name, t) == is_fp8_weight(name, t.ndim), name
        picked += ref_restore.fp8_weight(name, t)
    assert picked > 500
    x = torch.randn(4096, generator=torch.Generator().manual_seed(5)) * 100
    x[:3] = torch.tensor([470.0, -500.0, 448.0])
    torch.testing.assert_close(ref_restore.round_fp8(x), to_fp8(x, torch.bfloat16).float(),
                               equal_nan=True, rtol=0, atol=0)


def test_int4_control_is_coarser_than_fp8():
    w = torch.randn(64, 128, generator=torch.Generator().manual_seed(6)) / 128 ** 0.5
    e8 = (ref_restore.round_fp8(w) - w).norm() / w.norm()
    e4 = (ref_restore.round_int4(w) - w).norm() / w.norm()
    assert e4 > 3 * e8
    assert ref_restore.round_int4(w).unique().numel() <= 64 * 15


def test_schedule_matches_port():
    from faithdiff_tpu_torch.config import SchedulerConfig
    from faithdiff_tpu_torch.schedulers import EulerDiscreteScheduler

    import harness
    cfg = harness.load_json(f"{harness.BENCH}/configs/faithdiff-sdxl-bf16.json")
    ts, sigmas, init = ref_restore.euler_schedule(cfg["scheduler"], 20)
    state = EulerDiscreteScheduler(_port_config(SchedulerConfig, cfg["scheduler"])).set_timesteps(20)
    np.testing.assert_array_equal(ts, state.timesteps.numpy())
    np.testing.assert_allclose(sigmas, state.sigmas.numpy(), rtol=1e-6)
    assert init == pytest.approx(state.init_noise_sigma, rel=1e-6)


@pytest.mark.parametrize("h,w,n", [(128, 192, 2), (192, 256, 6), (256, 384, 15), (64, 64, 1)])
def test_tile_grid_matches_port(h, w, n):
    from faithdiff_tpu_torch.pipelines.tiling import (compute_tile_layout,
                                                      gaussian_tile_weights)

    offsets = ref_restore.tile_offsets(h, w, (128, 128), 0.5)
    layout = compute_tile_layout(h, w, (128, 128), 0.5)
    assert offsets == list(layout.offsets) and len(offsets) == n
    k1, k2 = layout.kernel
    np.testing.assert_array_equal(ref_restore.gaussian_weights(k1, k2).numpy(),
                                  gaussian_tile_weights(k1, k2))
