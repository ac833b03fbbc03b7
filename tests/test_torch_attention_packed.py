"""The port's packed-layout attention (`einsum_bsnd`, `attention_packed`,
the UNet `Attention` under `_BSND_ATTN`) against the JAX package: its
`_einsum_bsnd`, its Pallas BSND kernel in interpret mode, and its flax
modules and UNet on the packed path. Inputs come from numpy and go to both
sides; fp32 throughout, so the tolerances only cover summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.config import tiny_unet_config
from faithdiff_tpu.models import transformer2d as jax_t2d
from faithdiff_tpu.models.unet import \
    UNet2DConditionModel as FlaxUNet2DConditionModel
from faithdiff_tpu.ops.attention import _einsum_bsnd
from faithdiff_tpu.ops.attention import attention_packed as jax_attention_packed
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import transformer2d as t2d
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops.attention import (attention_packed, einsum_bsnd,
                                               flash_attention_packed)
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import nchw, nhwc, random_params


def _packed(b, sq, skv, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, f)).astype(np.float32),
            rng.standard_normal((b, skv, f)).astype(np.float32),
            rng.standard_normal((b, skv, f)).astype(np.float32))


@pytest.mark.parametrize("sq,skv,heads,d", [(8, 8, 2, 16), (16, 4, 4, 8)])
def test_einsum_bsnd_matches_jax(sq, skv, heads, d):
    q, k, v = _packed(2, sq, skv, heads * d, 0)
    ours = einsum_bsnd(*(torch.from_numpy(a) for a in (q, k, v)), heads,
                       1.0 / np.sqrt(d))
    want = _einsum_bsnd(*(jnp.asarray(a) for a in (q, k, v)), heads,
                        1.0 / np.sqrt(d))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("b,heads,sq,skv", [(2, 3, 256, 512),
                                            (1, 2, 128, 2048)])  # 2 kv blocks
def test_packed_plain_matches_pallas_bsnd_interpret(b, heads, sq, skv):
    """The packed kernel's plain version (what `flash_attention_packed`
    computes for CPU tensors) against the Pallas BSND kernel: head slicing
    and the per-head online softmax carried across kv blocks."""
    d = 64
    q, k, v = _packed(b, sq, skv, heads * d, 1)
    _build.launches.clear()
    ours = flash_attention_packed(*(torch.from_numpy(a) for a in (q, k, v)),
                                  heads, 1.0 / np.sqrt(d))
    assert sum(_build.launches.values()) == 0
    want = jax_attention_packed(*(jnp.asarray(a) for a in (q, k, v)), heads,
                                use_flash=True, interpret=True)
    # the Pallas kernel's base-2 online softmax against one fp32 softmax
    # (the JAX package's own test allows 2e-3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=2e-3)


def test_cpu_packed_dispatch_runs_plain_version_and_launches_nothing():
    """A kernel-eligible packed shape (self-attention at 1024 tokens, d=64)
    on CPU tensors goes through the wrapper's plain version."""
    q, k, v = (torch.from_numpy(a) for a in _packed(1, 1024, 1024, 128, 2))
    _build.launches.clear()
    out = attention_packed(q, k, v, 2)
    assert torch.equal(out, einsum_bsnd(q, k, v, 2, 0.125))
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("cross", [False, True])
def test_attention_packed_path_matches_default(monkeypatch, cross):
    """The port's Attention gives the same output with the packed path on
    and off, for self- and cross-attention."""
    torch.manual_seed(3)
    attn = t2d.Attention(32, 4, 8, cross_attention_dim=24 if cross else None)
    x = torch.randn(2, 16, 32)
    ctx = torch.randn(2, 7, 24) if cross else None
    monkeypatch.setattr(t2d, "_BSND_ATTN", False)
    with torch.no_grad():
        base = attn(x, ctx)
        monkeypatch.setattr(t2d, "_BSND_ATTN", True)
        packed = attn(x, ctx)
    torch.testing.assert_close(packed, base, atol=2e-6, rtol=0)


@pytest.mark.parametrize("module", ["attention", "transformer2d"])
def test_packed_modules_match_flax(monkeypatch, module):
    """The flax Attention / Transformer2DModel and the port's on the packed
    path in both packages, weights carried by `state_dict_from_flax`. The
    flax modules are applied unjitted, so the switch is read as they
    trace."""
    monkeypatch.setattr(jax_t2d, "_BSND_ATTN", True)
    monkeypatch.setattr(t2d, "_BSND_ATTN", True)
    rng = np.random.default_rng(4)
    if module == "attention":
        x = rng.standard_normal((2, 16, 32)).astype(np.float32)
        ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
        fmod = jax_t2d.Attention(query_dim=32, heads=4, dim_head=8,
                                 cross_attention_dim=24)
        port = t2d.Attention(32, 4, 8, cross_attention_dim=24)
        to_port = torch.from_numpy
    else:
        x = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
        ctx = rng.standard_normal((2, 11, 48)).astype(np.float32)
        fmod = jax_t2d.Transformer2DModel(32, 4, 8, 2, 48, norm_num_groups=8)
        port = t2d.Transformer2DModel(32, 4, 8, 2, 48, 8)
        to_port = nchw
    params = random_params(fmod, 5, jnp.asarray(x), jnp.asarray(ctx))
    want = np.asarray(fmod.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        ours = port.eval()(to_port(x), torch.from_numpy(ctx))
    ours = ours.numpy() if module == "attention" else nhwc(ours)
    np.testing.assert_allclose(ours, want, atol=5e-5)


def test_tiny_unet_on_the_packed_path_matches_flax(monkeypatch):
    """The slice as a whole: the tiny UNet with every Attention on the
    packed path, in both packages, fusion included."""
    monkeypatch.setattr(jax_t2d, "_BSND_ATTN", True)
    monkeypatch.setattr(t2d, "_BSND_ATTN", True)
    cfg = tiny_unet_config()
    model = FlaxUNet2DConditionModel(config=cfg)
    rng = np.random.default_rng(6)
    batch, s = 4, 16
    sample = rng.standard_normal((batch, s, s, 4)).astype(np.float32)
    t = np.array([500.0, 20.0] * (batch // 2), np.float32)
    ctx = rng.standard_normal((batch, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((batch, 64)).astype(np.float32)
    time_ids = np.tile(np.array([[128., 96., 0., 4., 128., 96.]], np.float32),
                       (batch, 1))
    cond = rng.standard_normal((batch, s, s, 64)).astype(np.float32)
    args = [jnp.asarray(a) for a in (sample, t, ctx, pooled, time_ids, cond)]
    params = random_params(model, 7, *args)
    # a fresh jit, traced after the switch is set
    want = jax.jit(lambda p, *a: model.apply(p, *a, add_sample=True,
                                             fusion_group_size=2))(params, *args)

    port = UNet2DConditionModel(tcfg.tiny_unet_config()).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return attention_packed(*a, **kw)

    monkeypatch.setattr(t2d, "attention_packed", counted)
    with torch.no_grad():
        ours = port(nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx),
                    torch.from_numpy(pooled), torch.from_numpy(time_ids),
                    nchw(cond), add_sample=True, fusion_group_size=2)
    # every Attention (attn1 and attn2 of each block) took the packed path
    blocks = sum(isinstance(m, t2d.BasicTransformerBlock) for m in port.modules())
    assert blocks > 0 and len(calls) == 2 * blocks
    # fp32; as the default path's full-UNet parity test
    np.testing.assert_allclose(nhwc(ours), np.asarray(want), atol=2e-4)
