"""The flash kernels at the wide head dims (d = 192 ... 512) on the CPU:
the port's gate against JAX's, the plain version against JAX's Pallas
kernel in interpret mode at the VAE's d = 512 attention, the wrapper's
strides, counters and refusals.

The kernels themselves run only on a card (`tests/test_torch_cuda.py`,
`chip_smoke.py`'s `attention_wide` lines). Here each entry point is
replaced by `strided_attention`, which reads q, k, v and writes the output
through exactly the element strides and sizes the wrapper hands the
kernel. Inputs come from numpy and go to both sides."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faithdiff_tpu.ops.attention as J
from faithdiff_tpu.ops.attention import _flash_attention_fwd_impl
from faithdiff_tpu_torch.models.unet_blocks import VaeAttention
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops import attention as A

HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512, 576)
LENGTHS = (512, 1000, 1024, 1088, 1152, 2048, 4096, 16384)


def _shape(*dims):
    return types.SimpleNamespace(shape=dims)


def _jax_takes_bhsd(q_len, kv_len, d, monkeypatch) -> bool:
    """Whether JAX's `multi_head_attention` sends [1, 1, S, d] to its
    kernel: its own gate, run with a TPU present and every route recorded
    (only shapes are read)."""
    route = []
    monkeypatch.setattr(J, "_on_tpu", lambda: True)
    monkeypatch.setattr(J, "_flash_attention", lambda *a: route.append("flash"))
    monkeypatch.setattr(J, "_chunked_xla_attention", lambda *a: route.append("chunked"))
    monkeypatch.setattr(J, "_xla_attention", lambda *a: route.append("xla"))
    J.multi_head_attention(_shape(1, 1, q_len, d), _shape(1, 1, kv_len, d),
                           _shape(1, 1, kv_len, d))
    return route == ["flash"]


def _jax_takes_packed(q_len, kv_len, d, monkeypatch) -> bool:
    route = []
    monkeypatch.setattr(J, "_on_tpu", lambda: True)
    monkeypatch.setattr(J, "_flash_bsnd", lambda *a: route.append("flash"))
    monkeypatch.setattr(J, "_einsum_bsnd", lambda *a: route.append("einsum"))
    J.attention_packed(_shape(1, q_len, 2 * d), _shape(1, kv_len, 2 * d),
                       _shape(1, kv_len, 2 * d), heads=2)
    return route == ["flash"]


@pytest.mark.parametrize("layout", ["bhsd", "packed"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_gate_is_jax_gate_at_wide_head_dims(d, layout, monkeypatch):
    """Above d = 128 the port's gate is JAX's, to the shape; at d = 64 and
    128 it keeps its superset (no length multiple, no K/V cap)."""
    jax_takes = _jax_takes_bhsd if layout == "bhsd" else _jax_takes_packed
    for q_len in LENGTHS:
        for kv_len in LENGTHS:
            ours = A._flash_gate(q_len, kv_len, d, packed=layout == "packed")
            theirs = jax_takes(q_len, kv_len, d, monkeypatch)
            if d <= 128:
                assert ours or not theirs, (q_len, kv_len)
            else:
                assert ours == theirs, (q_len, kv_len)
    # the entry points' own gates read the same shapes
    if layout == "bhsd":
        assert A.flash_eligible(_shape(1, 1, 1024, d), _shape(1, 1, 1024, d)) == \
            A._flash_gate(1024, 1024, d)


def test_vae_attention_routes():
    """The VAE mid-attention (d = 512, one head) is the kernel's at a 32 x 32
    latent and chunked_attention's at 128 x 128 (a 1024 px tile), as JAX
    routes it."""
    assert A.flash_eligible(_shape(1, 1, 1024, 512), _shape(1, 1, 1024, 512))
    assert not A.flash_eligible(_shape(1, 1, 16384, 512), _shape(1, 1, 16384, 512))
    assert not A.flash_eligible(_shape(1, 1, 4096, 512), _shape(1, 1, 4096, 512))


def test_vae_attention_module_calls_the_kernel_entry(monkeypatch):
    """`VaeAttention` at a 32 x 32 latent reaches `flash_attention` (the
    d = 512 kernel on a card)."""
    seen = []
    real = A.flash_attention

    def spy(q, k, v, scale, causal=False):
        seen.append(tuple(q.shape))
        return real(q, k, v, scale, causal)

    monkeypatch.setattr(A, "flash_attention", spy)
    torch.manual_seed(0)
    attn = VaeAttention(512).eval()
    with torch.no_grad():
        attn(torch.randn(1, 512, 32, 32))
    assert seen == [(1, 1, 1024, 512)]


@pytest.mark.parametrize("d", [256, 512])
def test_plain_version_matches_pallas_interpret(d):
    """The wide kernels' plain version (`attention_reference`, what
    `flash_attention` computes on the CPU) against JAX's `_flash_kernel`
    in interpret mode at [1, 1, 1024, d] bf16: within the bf16 tolerance
    the card holds the kernels to (1e-2 + 8e-3 |ref|)."""
    rng = np.random.default_rng(30 + d)
    q, k, v = (rng.standard_normal((1, 1, 1024, d)).astype(np.float32)
               for _ in range(3))
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = A.flash_attention(tq, tk, tv, scale).float().numpy()
    want = np.asarray(_flash_attention_fwd_impl(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=scale,
        causal=False, block_q=512, block_k=512, interpret=True)).astype(np.float32)
    assert np.all(np.abs(ours - want) <= 1e-2 + 8e-3 * np.abs(want))


def strided_attention(q, k, v, out, strides, dims, scale, causal):
    """What the strided entry points compute, read through their
    arguments: per operand (batch, head, row) element strides, unit
    columns."""
    b, h, sq, skv, d = dims

    def view(t, i, rows):
        st = strides[3 * i:3 * i + 3]
        return torch.as_strided(t, (b, h, rows, d), (*st, 1), t.storage_offset())

    with torch.no_grad():
        view(out, 3, sq).copy_(A.attention_reference(
            view(q, 0, sq), view(k, 1, skv), view(v, 2, skv), scale, causal))


@pytest.fixture
def card_free_launch(monkeypatch):
    """The launch path with the device check and both strided entry points
    replaced; the wide bf16 one keeps its stride check."""
    def wide(q, k, v, out, strides, dims, scale, causal):
        A._check_strided_rows("flash_attention_wide", [
            (n, tuple(strides[3 * i:3 * i + 3])) for i, n in enumerate("qkvo")])
        strided_attention(q, k, v, out, strides, dims, scale, causal)

    monkeypatch.setattr(A, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(A, "_flash_f32_launch", strided_attention)
    monkeypatch.setattr(A, "_flash_wide_launch", wide)
    _build.launches.clear()


@pytest.mark.parametrize("dtype,counter", [
    (torch.bfloat16, "flash_attention_wide_fwd"),
    (torch.float32, "flash_attention_f32_wide_fwd")])
@pytest.mark.parametrize("d,causal", [(512, False), (192, True)])
def test_wide_launch_matches_pallas_interpret(card_free_launch, dtype, counter,
                                              d, causal):
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 2, 256, d)).astype(np.float32)
               for _ in range(3))
    scale = d ** -0.5
    ours = A.flash_attention_function(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), scale, causal)
    assert dict(_build.launches) == {counter: 1}
    want = np.asarray(_flash_attention_fwd_impl(
        *(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                             else jnp.float32) for a in (q, k, v)),
        scale=scale, causal=causal, block_q=128, block_k=128, interpret=True))
    if dtype == torch.float32:
        np.testing.assert_allclose(ours.numpy(), want, atol=2e-5)
    else:
        want = want.astype(np.float32)
        assert np.all(np.abs(ours.float().numpy() - want) <= 1e-2 + 8e-3 * np.abs(want))


@pytest.mark.parametrize("dtype,counter", [
    (torch.bfloat16, "flash_attention_wide_bsnd_fwd"),
    (torch.float32, "flash_attention_f32_wide_bsnd_fwd")])
def test_wide_packed_launch_matches_pallas_bsnd_interpret(card_free_launch, dtype,
                                                          counter):
    """q a column slice of a fused [b, s, 3f] projection, two heads of
    d = 256: the head stride is d columns into a row."""
    heads, d = 2, 256
    f = heads * d
    rng = np.random.default_rng(40)
    qkv, k, v = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 256, 3 * f), (2, 384, f), (2, 384, f)))
    tq = torch.from_numpy(qkv).to(dtype)[..., f:2 * f]
    ours = A.flash_attention_packed_function(
        tq, torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype), heads,
        d ** -0.5)
    assert dict(_build.launches) == {counter: 1}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(J.attention_packed(
        jnp.asarray(qkv[..., f:2 * f], jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        heads, use_flash=True, interpret=True)).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(ours.numpy(), want, atol=2e-5)
    else:
        assert np.all(np.abs(ours.float().numpy() - want) <= 1e-2 + 8e-3 * np.abs(want))


def test_wide_bf16_refuses_strides_off_16_bytes(card_free_launch):
    q = torch.zeros(1, 1024, 3 * 256 + 4, dtype=torch.bfloat16)[..., :256]
    k = torch.zeros(1, 1024, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not packed rows|multiples of 8"):
        A.flash_attention_packed_function(q, k, k, 1, 0.0625)


@pytest.mark.parametrize("d,match", [(576, r"above 512.*ROADMAP §2"),
                                     (200, r"head dim 200, kernels take"),
                                     (32, r"head dim 32, kernels take")])
@pytest.mark.parametrize("layout", ["bhsd", "packed"])
def test_launches_refuse_head_dims_no_kernel_has(d, match, layout):
    """The kernel launches (what a CUDA tensor reaches) refuse d = 576 and
    head dims that are no multiple of 64, before anything else."""
    if layout == "bhsd":
        t = torch.zeros(1, 1, 8, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            A._flash_attention_launch(t, t, t, 0.1, False)
    else:
        t = torch.zeros(1, 8, 2 * d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            A._flash_packed_launch(t, t, t, 2, 0.1)


def test_wide_launch_on_the_cpu_is_refused_as_a_device():
    t = torch.zeros(1, 1, 8, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        A._flash_attention_launch(t, t, t, 0.1, False)
