"""The roofline arithmetic (`benchmark/roofline.py`): the kernel table's
bounds, and the FLOP count of a UNet call against a count by hand."""
import os

import pytest

import harness
import roofline

HERE = os.path.dirname(os.path.abspath(__file__))


def test_flash_bound_is_the_kernel_tables():
    """[4, 10, 4096, 64] bf16: 171.8 GFLOP at 989 TFLOP/s, 0.1737 ms."""
    flops, nbytes = roofline.attention_work(4, 10, 4096, 4096, 64)
    ms = roofline.least_seconds(flops, nbytes, roofline.PEAK_BF16_FLOPS) * 1e3
    assert ms == pytest.approx(0.1737, abs=5e-5)
    assert flops / roofline.PEAK_BF16_FLOPS > nbytes / roofline.PEAK_BYTES


def test_group_norm_bound_is_the_kernel_tables():
    """[4, 640, 64, 64] bf16: x read and y written once at 3.35 TB/s,
    0.01252 ms."""
    flops, nbytes = roofline.group_norm_work((4, 640, 64, 64), act=False, add=False)
    ms = roofline.least_seconds(flops, nbytes, roofline.PEAK_FP32_FLOPS) * 1e3
    assert ms == pytest.approx(0.01252, abs=5e-6)


def _conv(b, cin, cout, h, w, k=3):
    return 2 * b * cout * h * w * cin * k * k


def _linear(m, cin, cout):
    return 2 * m * cin * cout


def _hand_unet_flops(u, b, k, tokens):
    """Convolutions and matrix products of one UNet call of `b` latents of
    k x k, counted from the configuration by hand."""
    ch, heads = u["block_out_channels"], u["attention_head_dim"]
    depth, layers = u["transformer_layers_per_block"], u["layers_per_block"]
    temb, xdim = 4 * ch[0], u["cross_attention_dim"]
    total = _linear(b, ch[0], temb) + _linear(b, temb, temb)
    total += _linear(b, u["projection_class_embeddings_input_dim"], temb) + _linear(b, temb, temb)
    total += _conv(b, u["in_channels"], ch[0], k, k)
    cc = u["condition_channels"]
    total += _conv(b, cc, cc, k, k) + _conv(b, cc, ch[0], k, k)
    d, hw = u["info_transformer_dim"], k * k
    for _ in range(u["info_transformer_layers"]):
        rows = b * hw
        # attention over each tile's CFG pair (2 tokens) a pixel
        total += _linear(rows, d, 3 * d) + 2 * 2 * rows * 2 * d + _linear(rows, d, d)
        total += _linear(rows, d, 2 * d) + _linear(rows, 2 * d, d)
    total += _linear(b * hw, d, ch[0])

    def resnet(cin, cout, res):
        f = _conv(b, cin, cout, res, res) + _conv(b, cout, cout, res, res)
        f += _linear(b, temb, cout)
        if cin != cout:
            f += _conv(b, cin, cout, res, res, 1)
        return f

    def transformer(c, n_heads, n_blocks, res):
        s = res * res
        f = 2 * _linear(b * s, c, c)                       # proj_in, proj_out
        for _ in range(n_blocks):
            f += 4 * _linear(b * s, c, c)                  # attn1 q, k, v, out
            f += 2 * 2 * b * s * s * c                     # q k^T and p v
            f += 2 * _linear(b * s, c, c) + 2 * _linear(b * tokens, xdim, c)
            f += 2 * 2 * b * s * tokens * c
            f += _linear(b * s, c, 8 * c) + _linear(b * s, 4 * c, c)
        return f

    res, cin, skips = k, ch[0], [ch[0]]
    n = len(ch)
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(layers):
            total += resnet(cin if j == 0 else ch[i], ch[i], res)
            if kind.startswith("CrossAttn"):
                total += transformer(ch[i], heads[i], depth[i], res)
            skips.append(ch[i])
        if i < n - 1:
            total += _conv(b, ch[i], ch[i], res // 2, res // 2)
            skips.append(ch[i])
            res //= 2
        cin = ch[i]
    total += 2 * resnet(ch[-1], ch[-1], res) + transformer(ch[-1], heads[-1], depth[-1], res)
    prev = ch[-1]
    for i, kind in enumerate(u["up_block_types"]):
        r = n - 1 - i
        for j in range(layers + 1):
            total += resnet((prev if j == 0 else ch[r]) + skips.pop(), ch[r], res)
            if kind.startswith("CrossAttn"):
                total += transformer(ch[r], heads[r], depth[r], res)
        if i < n - 1:
            res *= 2
            total += _conv(b, ch[r], ch[r], res, res)
        prev = ch[r]
    total += _conv(b, ch[0], u["out_channels"], k, k)
    return total


@pytest.mark.parametrize("batch", [2, 4])
def test_unet_flops_are_the_hand_count(batch):
    cfg = harness.load_json(os.path.join(HERE, "tiny_config.json"))
    got = roofline.stage_flops(cfg, 256, 256, batch)["unet"]
    assert got == _hand_unet_flops(cfg["unet"], batch, 32, 77)


def test_full_width_unet_flops_per_tile_step():
    """One CFG pair of 128 x 128 latents at the published widths: ~14.2
    TFLOP (counted over the reference on the meta device)."""
    cfg = harness.load_json(os.path.join(harness.BENCH, "configs", "faithdiff-sdxl-bf16.json"))
    got = roofline.stage_flops(cfg, 1024, 1024, 2)["unet"]
    assert got == _hand_unet_flops(cfg["unet"], 2, 128, 77)
    assert 13e12 < got < 16e12


def test_self_attention_list_covers_every_transformer_block():
    cfg = harness.load_json(os.path.join(harness.BENCH, "configs", "faithdiff-sdxl-bf16.json"))
    calls = roofline.unet_self_attention(cfg["unet"], (128, 128), 4)
    # 1 + 1 + 1 (x2 down, x3 up) at 64^2 would be depth 1 at 320 ch, none;
    # depth 2 at 64^2: 2 down + 3 up; depth 10 at 32^2: 2 down + 1 mid + 3 up
    assert calls.count((4, 10, 4096, 64)) == 10
    assert calls.count((4, 20, 1024, 64)) == 60
    assert len(calls) == 70


def test_unet_batches_split_at_the_chunk():
    assert roofline.unet_batches(2, 8) == [4]
    assert roofline.unet_batches(6, 8) == [12]
    assert roofline.unet_batches(15, 8) == [16, 14]
