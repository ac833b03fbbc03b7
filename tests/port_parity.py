"""Helpers shared by the `test_torch_*` parity tests: flax params made with
numpy, and NHWC <-> NCHW conversions between the two packages."""
import jax
import numpy as np
import torch


def random_params(fmod, seed, *init_args, method=None,
                  norm_leaves=("scale",)):
    """Flax params of `fmod` made with numpy, without running its init:
    kernels N(0, 1/fan_in), biases 0.1 N(0, 1), norm scales (leaves named
    in `norm_leaves`) 1 + 0.1 N(0, 1), so no bias or norm affine sits at a
    trivial value (zero-init fusion outputs included). `method` is passed
    to `init`."""
    rng = np.random.default_rng(seed)
    kwargs = {} if method is None else {"method": method}
    shapes = jax.eval_shape(lambda: fmod.init(jax.random.PRNGKey(0),
                                              *init_args, **kwargs))

    def make(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        return 1 + 0.1 * x if name in norm_leaves else 0.1 * x

    return jax.tree_util.tree_map_with_path(make, shapes)


def nchw(x):
    """NHWC numpy -> contiguous NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)
                                                 .transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def tiny_restore_params():
    """Flax params of the JAX package's tiny UNet, VAE and denoise encoder,
    made with numpy (seeds 0, 1, 2)."""
    import jax.numpy as jnp

    from faithdiff_tpu.config import (tiny_denoise_encoder_config,
                                      tiny_unet_config, tiny_vae_config)
    from faithdiff_tpu.models.unet import UNet2DConditionModel
    from faithdiff_tpu.models.vae import AutoencoderKL, DenoiseEncoder

    z = jnp.zeros
    unet = random_params(UNet2DConditionModel(config=tiny_unet_config()), 0,
                         z((2, 8, 8, 4)), z((2,)), z((2, 77, 64)), z((2, 64)),
                         z((2, 6)), z((2, 8, 8, 64)))
    vae = random_params(AutoencoderKL(config=tiny_vae_config()), 1,
                        z((1, 64, 64, 3)))
    de = random_params(DenoiseEncoder(config=tiny_denoise_encoder_config()), 2,
                       z((1, 64, 64, 3)))
    return unet, vae, de


def jax_posterior_noise(seed, lh, lw):
    """The VAE posterior noise of the JAX pipeline's `seed` (its key
    split(PRNGKey(seed), 3)[2]) as NCHW torch, for the port's
    `models.vae.posterior_noise`."""
    import jax.numpy as jnp

    key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    noise = np.asarray(jax.random.normal(key, (1, lh, lw, 4), jnp.float32))
    return torch.from_numpy(noise.transpose(0, 3, 1, 2).copy())
