"""The LayerNorm launch plan (`ops/layernorm.plan_layer_norm`), the
kernel's schedule in plain PyTorch (`layer_norm_tiled`), the module's CPU
path and the gradient of `layer_norm_function`, on the CPU.

The plan is checked at every width the port's LayerNorms run at (the
full UNet's 640 and 1280, the CLIP towers' 768, 1024 and 1280, the tiny
configs' 32, 64 and 128) in bf16 and fp32, at odd widths, row-strided
views, unaligned starts and the shapes it refuses. The tile walk is held
against the plain version within fp32 rounding; the gradient against
`jax.vjp` of the JAX package's LayerNorm."""
import jax
import numpy as np
import pytest
import torch

from faithdiff_tpu.models.layers import LayerNorm as FlaxLayerNorm
from faithdiff_tpu_torch.config import tiny_unet_config
from faithdiff_tpu_torch.models.layers import LayerNorm
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.ops import layernorm as ln


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small shapes run no faster on more threads, and in the 6-worker test
    run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layout(shape, dtype=torch.bfloat16, stride=None):
    """A meta tensor of `shape` (or a view of `stride`), for its plan."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    return x if stride is None else x.as_strided(shape, stride)


def _check_geometry(plan, rows, d, itemsize):
    """What every plan holds: a power-of-two row of threads within a block,
    vectors that cover the row once, blocks that cover the rows once."""
    vec = 16 // itemsize
    tpr, n_vec = plan.threads_per_row, -(-d // vec)
    assert plan.vec == vec and plan.rows == rows and plan.d == d
    assert tpr & (tpr - 1) == 0 and 1 <= tpr <= ln.THREADS
    assert 1 <= plan.items <= ln.MAX_ITEMS
    assert plan.rows_per_block * tpr == ln.THREADS
    # the fewest threads: half as many would hold more than MAX_ITEMS each
    assert tpr == 1 or -(-n_vec // (tpr // 2)) > ln.MAX_ITEMS
    held = np.zeros(plan.items * tpr, np.int64)
    for t in range(tpr):
        for k in range(plan.items):
            held[t + k * tpr] += 1
    assert (held == 1).all() and plan.items * tpr >= n_vec > (plan.items - 1) * tpr
    assert plan.grid * plan.rows_per_block >= rows > (plan.grid - 1) * plan.rows_per_block
    assert plan.grid <= ln.MAX_GRID


# rows at UNet batch 12 (1536x2048: 6 tiles' CFG pairs) and 4, the fusion
# tokens, the CLIP towers' 77 tokens, a ViT-L's 577, the tiny configs'
PORT_SHAPES = [(12 * 1024, 1280), (12 * 4096, 640), (4 * 1024, 1280),
               (4 * 4096, 640), (6, 16384, 2, 640), (2, 16384, 2, 640),
               (2, 77, 768), (2, 77, 1280), (1, 577, 1024), (4, 256, 64),
               (4, 64, 128), (3, 77, 32), (2, 256, 2, 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PORT_SHAPES, ids=str)
def test_plan_at_the_ports_widths(shape, dtype):
    x = _layout(shape, dtype)
    plan = ln.plan_layer_norm(x.shape, x.stride(), x.element_size())
    rows = int(np.prod(shape[:-1]))
    _check_geometry(plan, rows, shape[-1], x.element_size())
    assert not plan.copy and plan.vector and plan.row_stride == shape[-1]


def test_plan_of_the_unet_widths():
    """640 and 1280 in bf16: five 16-byte vectors a thread, a row on 16 and
    32 threads, no lane idle."""
    for d, tpr in ((640, 16), (1280, 32)):
        plan = ln.plan_layer_norm((4096, d), (d, 1), 2)
        assert (plan.threads_per_row, plan.items, plan.vector) == (tpr, 5, True)


# (shape, stride or None, itemsize, aligned, copy, vector, row_stride)
LAYOUTS = [
    ((5, 33), None, 2, True, False, False, 33),              # odd d
    ((3, 4, 1001), None, 4, True, False, False, 1001),
    ((7, 2050), None, 2, True, False, False, 2050),          # d % 8 = 2
    ((4, 8, 640), (10240, 1280, 1), 2, True, False, True, 1280),   # column slice
    ((4, 8, 636), (10240, 1280, 1), 2, True, False, False, 1280),  # ragged slice
    ((4, 8, 640), (10272, 1284, 1), 2, True, False, False, 1284),  # row stride % 8
    ((4, 4, 640), (10240, 2560, 1), 2, True, False, True, 2560),   # every other row
    ((1, 4, 640), (99, 2560, 1), 2, True, False, True, 2560),      # size-1 dim
    ((5, 640), (0, 1), 2, True, False, True, 0),                   # expanded rows
    ((64, 640), None, 2, False, False, False, 640),                # x off 16 bytes
    # the fusion tokens as permuted: last dim strided, so a copy first
    ((3, 256, 2, 64), (32768, 1, 16384, 256), 2, True, True, True, 64),
    ((4, 3, 640), (640, 2560, 1), 2, True, True, True, 640),       # rows crossed
]


@pytest.mark.parametrize("shape,stride,itemsize,aligned,copy,vector,step",
                         LAYOUTS, ids=str)
def test_plan_of_odd_and_strided_layouts(shape, stride, itemsize, aligned,
                                         copy, vector, step):
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    x = _layout(shape, dtype, stride)
    plan = ln.plan_layer_norm(x.shape, x.stride(), itemsize, aligned)
    assert (plan.copy, plan.vector, plan.row_stride) == (copy, vector, step)
    _check_geometry(plan, int(np.prod(shape[:-1])), shape[-1], itemsize)


@pytest.mark.parametrize("shape,itemsize", [
    ((4, 16392), 2), ((4, 8200), 4), ((4, 16385), 2), ((4, 0), 2),
    ((4, 640), 8), ((4, 640), 1)], ids=str)
def test_plan_refuses_what_the_kernel_does_not_take(shape, itemsize):
    with pytest.raises(ValueError):
        ln.plan_layer_norm(shape, (shape[-1], 1), itemsize)


def test_plan_takes_the_widest_rows_a_block_holds():
    for d, itemsize in ((16384, 2), (8192, 4), (16383, 2)):
        plan = ln.plan_layer_norm((3, d), (d, 1), itemsize)
        assert plan.threads_per_row == ln.THREADS and plan.rows_per_block == 1


def _inputs(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(shape, generator=gen) + 0.3).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[-1], generator=gen)
    b = 0.1 * torch.randn(shape[-1], generator=gen)
    return x, w, b


# rows on one thread, a part of a warp, a warp, and four and eight warps
@pytest.mark.parametrize("shape,dtype", [
    ((3, 5, 33), torch.float32), ((64, 640), torch.float32),
    ((2, 40, 1280), torch.float32), ((4, 7, 1024), torch.float32),
    ((3, 4096), torch.float32), ((2, 8192), torch.float32),
    ((2, 30, 640), torch.bfloat16), ((5, 2050), torch.bfloat16),
    ((2, 9, 64), torch.float16)], ids=str)
def test_tile_walk_matches_plain(shape, dtype):
    """The walk's sums in the kernel's order against the plain version's:
    within fp32 rounding in fp32, within one rounding of the output type
    in bf16 and fp16."""
    x, w, b = _inputs(shape, dtype, 1)
    ref = ln.layer_norm_reference(x, w, b, 1e-5).float()
    got = ln.layer_norm_tiled(x, w, b, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        assert bool((err <= 2e-6 * (1 + ref.abs())).all()), float(err.max())
    else:
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        assert bool((err <= ulp * ref.abs() + 1e-6).all()), float(err.max())


def test_tile_walk_takes_a_strided_view():
    x, w, b = _inputs((4, 6, 1280), torch.float32, 2)
    view = x[..., :640]
    got = ln.layer_norm_tiled(view, w[:640], b[:640], 1e-6)
    ref = ln.layer_norm_reference(view.contiguous(), w[:640], b[:640], 1e-6)
    assert float((got - ref).abs().max()) <= 2e-6 * (1 + float(ref.abs().max()))


def _old_layer_norm(x, weight, bias, eps):
    """`models/layers.LayerNorm.forward` as it was before the kernel."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    m2 = x32.square().mean(dim=-1, keepdim=True)
    var = torch.clamp(m2 - mean.square(), min=0.0)
    x32 = (x32 - mean) * torch.rsqrt(var + eps)
    return (x32 * weight.float() + bias.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("shape", [(2, 77, 768), (3, 5, 33), (2, 4, 2, 64)],
                         ids=str)
def test_module_on_the_cpu_keeps_its_bits(shape, dtype):
    x, w, b = _inputs(shape, dtype, 3)
    mod = LayerNorm(shape[-1], eps=1e-6).to(dtype)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        got = mod(x)
        view = mod(x.transpose(0, 1))
    assert torch.equal(got, _old_layer_norm(x, mod.weight, mod.bias, 1e-6))
    assert torch.equal(view, _old_layer_norm(x.transpose(0, 1), mod.weight,
                                             mod.bias, 1e-6))


def test_layer_norm_refuses_other_devices():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError):
        ln.layer_norm(x, torch.ones(64, device="meta"),
                      torch.zeros(64, device="meta"))


class _Spy:
    """A forward that counts its calls and returns the plain version's."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("shape,eps", [((2, 5, 48), 1e-5), ((3, 33), 1e-6)],
                         ids=str)
def test_layer_norm_function_grads_match_jax(shape, eps):
    """The Function's gradients with respect to x, weight and bias against
    `jax.vjp` of the JAX package's LayerNorm, within 1e-5 * (1 + max|ref|):
    the backward differentiates the plain version."""
    rng = np.random.default_rng(4)
    x = (2 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    flax = FlaxLayerNorm(epsilon=eps)
    _, vjp = jax.vjp(lambda x, s, c: flax.apply(
        {"params": {"scale": s, "bias": c}}, x), x, w, b)
    ref = vjp(g)

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    spy = _Spy(ln.layer_norm_reference)
    out = ln.layer_norm_function(*leaves, eps, forward=spy)
    assert type(out.grad_fn).__name__ == "KernelWithPlainBackwardBackward"
    out.backward(torch.from_numpy(g))
    assert spy.calls == 1
    for t, r in zip(leaves, ref):
        r = np.asarray(r)
        err = np.abs(t.grad.numpy() - r).max()
        assert err <= 1e-5 * (1 + np.abs(r).max()), err


def test_every_unet_layer_norm_reads_its_rows_in_place():
    """The tiny UNet's forward on the CPU: each of its 3 x 17 transformer
    blocks' and 2 x 2 information-transformer LayerNorms gets an x whose
    plan needs no copy (the fusion tokens are made contiguous once), so
    `layer_norm.copies` reads 0 a call on the card."""
    torch.manual_seed(0)
    unet = UNet2DConditionModel(tiny_unet_config()).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((tuple(a[0].shape), a[0].stride())))
        for m in unet.modules() if isinstance(m, LayerNorm)]
    b, s = 4, 16
    with torch.no_grad():
        unet(torch.randn(b, 4, s, s), torch.tensor([500.0, 20.0] * 2),
             torch.randn(b, 77, 64), torch.randn(b, 64),
             torch.tensor([[128., 96., 0., 4., 128., 96.]] * b),
             torch.randn(b, 64, s, s), add_sample=True, fusion_group_size=2)
    for h in hooks:
        h.remove()
    assert len(seen) == 3 * 17 + 2 * 2
    for shape, stride in seen:
        assert not ln.plan_layer_norm(shape, stride, 2).copy, (shape, stride)
    assert (2, s * s, 2, 64) in [shape for shape, _ in seen]
