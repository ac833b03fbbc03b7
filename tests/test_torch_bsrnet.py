"""The port's BSRNet (`faithdiff_tpu_torch/models/bsrnet.py`) against the
JAX package's at a small width (nf 8, nb 2, gc 4), fp32: the network at
x4 and x2, `deg_remove` with one tile and with grids of tiles, and
`bsrnet_state_dict_from_flax`'s names."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.models import bsrnet as jb
from faithdiff_tpu_torch.models import bsrnet as tb
from faithdiff_tpu_torch.utils.convert import bsrnet_state_dict_from_flax
from port_parity import nchw, nhwc, random_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(sf, seed=0, nb=2):
    fmod = jb.RRDBNet(nf=8, nb=nb, gc=4, sf=sf)
    params = random_params(fmod, seed, jnp.zeros((1, 16, 16, 3)))
    ours = tb.RRDBNet(nf=8, nb=nb, gc=4, sf=sf)
    ours.load_state_dict(bsrnet_state_dict_from_flax(params), strict=True)
    return fmod, params, ours.eval()


def _image(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("sf", [4, 2])
def test_rrdbnet_matches_jax(sf):
    fmod, params, ours = _pair(sf)
    img = _image(16, 12)
    want = np.asarray(fmod.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = nhwc(ours(nchw(img)))
    assert got.shape == (1, 16 * sf, 12 * sf, 3)
    # fp32 on both sides; the convolutions sum in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile,pad,h,w,sf", [(32, 4, 16, 16, 4), (8, 4, 16, 16, 4),
                                             (8, 4, 13, 10, 4), (8, 4, 13, 10, 2)])
def test_deg_remove_matches_jax(tile, pad, h, w, sf):
    """One tile covering the input (equal to one forward), a 2 x 2 grid of
    tiles with halos, and a grid ragged at the edge at x4 and x2 (the port
    takes the scale from the model; one RRDB block: JAX compiles the
    network anew for each tile shape)."""
    fmod, params, ours = _pair(sf, seed=1, nb=1)
    img = _image(h, w, seed=tile + h)
    want = np.asarray(jb.deg_remove(jax.jit(fmod.apply), params, jnp.asarray(img),
                                    tile_size=tile, tile_pad=pad, scale=sf))
    calls = []
    handle = ours.register_forward_hook(lambda m, a, o: calls.append(a[0].shape))
    got = nhwc(tb.deg_remove(ours, nchw(img), tile_size=tile, tile_pad=pad))
    handle.remove()
    assert len(calls) == -(-h // tile) * -(-w // tile)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if tile >= max(h, w):
        with torch.no_grad():
            np.testing.assert_array_equal(got, nhwc(ours(nchw(img))))


def test_carry_names_are_the_reference_keys():
    """The carried keys are BSRNet's (`bsrnet_arch.py`) and invert the
    flax tree's names leaf for leaf."""
    _, params, ours = _pair(4)
    sd = bsrnet_state_dict_from_flax(params)
    assert set(sd) == set(ours.state_dict())
    assert "RRDB_trunk.1.RDB3.conv5.weight" in sd and "upconv2.bias" in sd
    kernel = np.asarray(params["params"]["RRDB_trunk_1"]["RDB2"]["conv4"]["kernel"],
                        np.float32)
    np.testing.assert_array_equal(sd["RRDB_trunk.1.RDB2.conv4.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    n_flax = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_flax
