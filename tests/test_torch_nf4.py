"""The port's weight-only quantisation (`utils/quantize.py`) and the NF4
kernel's plain version (`ops/nf4_matmul.py`) against the JAX package:
`quantize_nf4` / `repack_nf4` bytes, the Pallas `_nf4_matvec_kernel` in
interpret mode, the XLA `nf4_matmul` path, and the int8 path. Inputs come
from numpy; fp32 throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.nf4_matmul import nf4_matmul_fused
from faithdiff_tpu.utils import quantize as jq
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops.nf4_matmul import nf4_matmul_reference
from faithdiff_tpu_torch.utils import quantize as tq


def _weights(in_f, out_f, seed):
    """[in, out] fp32 with some blocks all zero and some constant, so the
    absmax floor and the argmin ties are exercised."""
    w = np.random.default_rng(seed).standard_normal((in_f, out_f)).astype(np.float32)
    w[:64, 0] = 0.0
    w[64:128, 1] = 0.5
    w[:64, 2] = np.float32(0.3) * jq.NF4_CODE[np.arange(64) % 16]
    return w


def _to_jax(q):
    return jq.NF4Weight(packed=jnp.asarray(q.packed.numpy()),
                        absmax=jnp.asarray(q.absmax.numpy()),
                        shape=q.shape, pack_format=q.pack_format)


@pytest.mark.parametrize("in_f,out_f", [(128, 8), (512, 288), (192, 40)])
def test_quantize_nf4_bytes_equal_jax(in_f, out_f):
    w = _weights(in_f, out_f, in_f + out_f)
    ours = tq.quantize_nf4(torch.from_numpy(w))
    want = jq.quantize_nf4(jnp.asarray(w))
    assert ours.packed.dtype == torch.uint8 and ours.shape == tuple(want.shape)
    np.testing.assert_array_equal(ours.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(ours.absmax.numpy(), np.asarray(want.absmax))
    # decode: the same fp32 values
    np.testing.assert_array_equal(tq.dequantize_nf4(ours, torch.float32).numpy(),
                                  np.asarray(jq.dequantize_nf4(want, jnp.float32)))


def test_quantize_nf4_chunks_rows(monkeypatch):
    """Row chunking gives the bytes of one whole pass."""
    w = torch.from_numpy(_weights(256, 48, 5))
    whole = tq.quantize_nf4(w)
    monkeypatch.setattr(tq, "_QUANT_CHUNK_ELEMS", 256 * 5)
    chunked = tq.quantize_nf4(w)
    assert torch.equal(whole.packed, chunked.packed)
    assert torch.equal(whole.absmax, chunked.absmax)


def test_repack_nf4_from_both_legacy_layouts():
    in_f, out_f = 256, 16
    w = _weights(in_f, out_f, 4)
    q = tq.quantize_nf4(torch.from_numpy(w))
    p = q.packed.numpy()
    idx = np.concatenate([p >> 4, p & 0xF], axis=1).reshape(-1, 64)
    flat_absmax = q.absmax.numpy().reshape(-1)
    layouts = {
        tq.NF4_PACK_PAIRWISE: (idx[:, 0::2] << 4) | idx[:, 1::2],
        tq.NF4_PACK_HALFBLOCK: (idx[:, :32] << 4) | idx[:, 32:],
    }
    for fmt, packed in layouts.items():
        legacy = tq.NF4Weight(torch.from_numpy(packed.astype(np.uint8)),
                              torch.from_numpy(flat_absmax), q.shape, fmt)
        with pytest.raises(ValueError):
            tq.dequantize_nf4(legacy)
        ours = tq.repack_nf4(legacy)
        want = jq.repack_nf4(_to_jax(legacy))
        assert ours.pack_format == tq.NF4_PACK_HALFROW
        np.testing.assert_array_equal(ours.packed.numpy(), np.asarray(want.packed))
        np.testing.assert_array_equal(ours.packed.numpy(), p)
        np.testing.assert_array_equal(ours.absmax.numpy(), np.asarray(want.absmax))


@pytest.mark.parametrize("x_shape,in_f,out_f", [
    ((1, 512), 512, 256), ((4, 1024), 1024, 512), ((3, 512), 512, 288),
    ((2, 3, 512), 512, 256)])
def test_plain_version_matches_pallas_interpret_and_xla(x_shape, in_f, out_f):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((in_f, out_f)) * 0.05).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    q = tq.quantize_nf4(torch.from_numpy(w))
    ours = nf4_matmul_reference(torch.from_numpy(x), q).numpy()
    jqw = jq.quantize_nf4(jnp.asarray(w))
    pallas = nf4_matmul_fused(jnp.asarray(x), jqw, compute_dtype=jnp.float32,
                              interpret=True)
    xla = jq.nf4_matmul(jnp.asarray(x), jqw, compute_dtype=jnp.float32,
                        use_fused=False)
    assert ours.shape == x_shape[:-1] + (out_f,)
    # identical decoded values on all sides, fp32 sums in another order
    np.testing.assert_allclose(ours, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(xla), rtol=1e-5, atol=1e-5)


def test_int8_matches_jax():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 40)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    ours = tq.quantize_int8(torch.from_numpy(w))
    want = jq.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(ours.scales.numpy(), np.asarray(want.scales))
    y = tq.int8_matmul(torch.from_numpy(x), ours).numpy()
    # the same int8 values and scales; fp32 sums in another order
    np.testing.assert_allclose(
        y, np.asarray(jq.int8_matmul(jnp.asarray(x), want, jnp.float32)),
        rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_runs_plain_version_and_launches_nothing():
    rng = np.random.default_rng(2)
    q = tq.quantize_nf4(torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32))
    _build.launches.clear()
    out = tq.nf4_matmul(x, q)
    assert torch.equal(out, nf4_matmul_reference(x, q))
    assert _build.launches["nf4_matmul"] == 0
    assert sum(_build.launches.values()) == 0
    with pytest.raises(ValueError):
        tq.nf4_matmul(x, q._replace(pack_format=tq.NF4_PACK_PAIRWISE))
