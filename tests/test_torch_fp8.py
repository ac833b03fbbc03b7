"""`restore --use_fp8` in the port against the JAX package: the UNet
weights it stores in fp8 and their bits (`utils/quantize.py`), the
overflow rule of the cast, fp8 storage in the model
(`models/layers.store_fp8_`: one UNet call equal bit for bit to the call
on the upcast weights), the tiny fp8 pipeline at `test_torch_pipeline.py`'s
tolerance, the checkpoint delta utilities, and the CLI flag."""
import ml_dtypes
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.pipelines.factory import \
    build_tiny_pipeline as jax_build_tiny_pipeline
from faithdiff_tpu.utils import quantize as jq
from faithdiff_tpu_torch import cli
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models.layers import store_fp8_
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils import quantize as tq
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import tiny_restore_params


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return tiny_restore_params()


def _f32(tree):
    """A JAX tree with every leaf upcast to fp32 numpy (fp8 -> fp32 is
    exact; numpy's float8 does not pass through `torch.from_numpy`)."""
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32), tree)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fp8_picks_and_bits_match_jax(params, dtype):
    """The JAX factory casts to the compute dtype, then to fp8; the port
    picks the same tensors by their flax names and gives the same bits."""
    unet = params[0]
    tdtype = getattr(torch, dtype)
    # numpy leaves: the JAX function's casts are then ml_dtypes' (JAX's own)
    # without a dispatch per leaf
    npdtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jtree = jax.tree.map(lambda p: np.asarray(p).astype(npdtype), unet)
    jq8 = jq.quantize_params_fp8(jtree)
    is8 = jax.tree.map(lambda x: np.full(x.shape, float(x.dtype == jnp.float8_e4m3fn),
                                         np.float32), jq8)
    assert any(v.dtype == jnp.float8_e4m3fn for v in jax.tree.leaves(jq8))
    want_keys = {k for k, v in state_dict_from_flax(is8).items() if v.all()}
    want = state_dict_from_flax(_f32(jq8))
    sd = {k: v.to(tdtype) for k, v in state_dict_from_flax(unet).items()}
    got = tq.quantize_params_fp8(sd, tdtype)
    got_keys = {k for k, v in got.items() if v.dtype == torch.float8_e4m3fn}
    assert got_keys == want_keys and 0 < len(got_keys) < len(got)
    for k, v in got.items():
        np.testing.assert_array_equal(v.float().numpy(), want[k].numpy(),
                                      err_msg=k)
    back = tq.dequantize_params(got, tdtype)
    assert all(v.dtype == tdtype for v in back.values())
    assert tq.param_bytes(got) < tq.param_bytes(sd)


@pytest.mark.parametrize("src", ["bfloat16", "float32"])
def test_fp8_overflow_is_nan_as_in_jax(src):
    """torch saturates 480 and up to 448; ml_dtypes (JAX) gives NaN above
    464 (the midpoint to 480). The port follows JAX."""
    vals = np.array([0.0, -0.0, 1e-9, 0.3, 446, 448, 450, 460, 464, 465, 466,
                     470, 480, 500, 1e4, np.inf, -np.inf, np.nan, -460, -466,
                     -1e4], np.float32)
    if src == "float32":
        vals = np.concatenate([vals, np.float32([463.99, 464.01])])
    want = (vals.astype(getattr(ml_dtypes, src) if src == "bfloat16" else np.float32)
            .astype(ml_dtypes.float8_e4m3fn).astype(np.float32))
    got = tq.to_fp8(torch.from_numpy(vals), getattr(torch, src)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert torch.from_numpy(vals).to(torch.bfloat16).to(
        torch.float8_e4m3fn).float()[12] == 448      # torch's own cast


def test_fp8_storage_is_bitwise_the_upcast_call(params):
    """A UNet holding fp8 weights equals, bit for bit, the UNet whose
    weights are those fp8 values upcast."""
    cfg = tcfg.tiny_unet_config()
    sd = state_dict_from_flax(params[0])
    q = tq.quantize_params_fp8(sd, torch.float32)
    stored, upcast = UNet2DConditionModel(cfg), UNet2DConditionModel(cfg)
    stored.load_state_dict(sd)
    # as `build_pipeline` leaves them: a parameter that requires grad
    # changes how `torch.matmul` folds a strided input, and its rounding
    for m in (stored, upcast):
        m.eval().requires_grad_(False)
    assert store_fp8_(stored, q) == sum(v.dtype == torch.float8_e4m3fn
                                        for v in q.values())
    upcast.load_state_dict(tq.dequantize_params(q, torch.float32))
    dtypes = {v.dtype for v in stored.state_dict().values()}
    assert dtypes == {torch.float32, torch.float8_e4m3fn}
    rng = np.random.default_rng(0)

    def arg(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    args = (arg(2, 4, 8, 8), torch.tensor([999.0, 10.0]), arg(2, 77, 64),
            arg(2, 64), arg(2, 6), arg(2, 64, 8, 8))
    with torch.no_grad():
        a = stored(*args)
        b = upcast(*args)
    assert torch.equal(a, b)


def test_fp8_pipeline_matches_jax(params):
    """JAX's `quantize_params_fp8` passes over float64 leaves, and
    `random_params`' kernels are float64 numpy: the UNet goes in as fp32,
    as a flax init makes it, so that JAX's side holds fp8 weights too."""
    unet, vae, de = params
    unet = jax.tree.map(lambda p: np.asarray(p, np.float32), unet)
    jpipe = jax_build_tiny_pipeline(
        pipeline_config=JaxPipelineConfig(tile_size=64, num_inference_steps=3),
        unet_params=unet, vae_params=vae, denoise_encoder_params=de,
        use_fp8=True)
    tpipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=3),
        unet_state_dict=state_dict_from_flax(unet),
        vae_state_dict=state_dict_from_flax(vae),
        denoise_encoder_state_dict=state_dict_from_flax(de), device="cpu",
        use_fp8=True)
    assert any(v.dtype == torch.float8_e4m3fn
               for v in tpipe.unet.state_dict().values())
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    pe = rng.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 64)).astype(np.float32)
    want = jpipe(img, jnp.asarray(pe), jnp.asarray(pooled), seed=3,
                 output_type="latent", noise_source="torch",
                 start_point="noise")
    got = tpipe(img, pe, pooled, seed=3, output_type="latent",
                start_point="noise")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_delta_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    base = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "emb": rng.standard_normal((5, 2)).astype(np.float32)}
    target = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "emb": rng.standard_normal((7, 2)).astype(np.float32)}
    jdelta = jq.make_delta(base, target)
    tb = {k: torch.from_numpy(v) for k, v in base.items()}
    tt = {k: torch.from_numpy(v) for k, v in target.items()}
    delta = tq.make_delta(tb, tt)
    for k in base:
        np.testing.assert_array_equal(delta[k].numpy(), np.asarray(jdelta[k]))
    back = tq.apply_delta(tb, delta)
    jback = jq.apply_delta(base, jdelta)
    for k in base:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


def test_cli_restore_use_fp8(tmp_path):
    """`restore --use_fp8` runs (it raised before the port served it)."""
    img = np.random.default_rng(3).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    (tmp_path / "in").mkdir()
    Image.fromarray(img).save(tmp_path / "in" / "a.png")
    assert cli.main(["restore", "--use_fp8", "--tiny", "--device", "cpu",
                     "--img_dir", str(tmp_path / "in"), "--save_dir",
                     str(tmp_path / "out"), "--num_inference_steps", "2",
                     "--start_point", "noise"]) == 0
    out = np.asarray(Image.open(tmp_path / "out" / "a.png"))
    assert out.shape == (32, 48, 3) and out.dtype == np.uint8
