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
