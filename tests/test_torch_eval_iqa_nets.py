"""The port's IQA networks (`faithdiff_tpu_torch/eval/`) against the JAX
package's, fp32 on the CPU: LPIPS (AlexNet and VGG16), DISTS, the FID
InceptionV3, PaQ-2-PiQ, MUSIQ, MANIQA and CLIPIQA at their real structure
(the transformer metrics at the JAX tests' tiny configs, carried in the
files' `_config`), with the host preprocessing each factory does.

Each network starts from an upstream torch state dict (the JAX tests'
torch mirrors, transformers' CLIPModel names, torchvision names); the JAX
converter makes the flax tree and the JAX writer the file, which both
sides' `make_*` load: scores and features agree within 1e-4 * (1 + |ref|)
(the networks the harness test scores end to end are scored there once:
LPIPS-AlexNet, DISTS, PaQ-2-PiQ, MUSIQ, MANIQA, CLIPIQA's prompt ids). The
port's converter gives the same tree, and the port's writer a file whose
arrays JAX's loader reads back equal (so JAX scores it the same). The
resizes are held byte for byte against Pillow (MUSIQ's BILINEAR, MANIQA's
BICUBIC) and against `jax.image.resize` within 1e-6 (CLIPIQA's position
grid) or 1e-5 (FID's 299 input). NIQE is the JAX module's numpy, held
within 1e-9; PSNR and SSIM within 1e-5."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from faithdiff_tpu.eval import clipiqa as jclip
from faithdiff_tpu.eval import dists as jdists
from faithdiff_tpu.eval import fid as jfid
from faithdiff_tpu.eval import lpips as jlpips
from faithdiff_tpu.eval import maniqa as jmaniqa
from faithdiff_tpu.eval import metrics as jmetrics
from faithdiff_tpu.eval import musiq as jmusiq
from faithdiff_tpu.eval import niqe as jniqe
from faithdiff_tpu.eval import paq2piq as jpaq
from faithdiff_tpu_torch.eval import clipiqa as tclip
from faithdiff_tpu_torch.eval import dists as tdists
from faithdiff_tpu_torch.eval import fid as tfid
from faithdiff_tpu_torch.eval import lpips as tlpips
from faithdiff_tpu_torch.eval import maniqa as tmaniqa
from faithdiff_tpu_torch.eval import metrics as tmetrics
from faithdiff_tpu_torch.eval import musiq as tmusiq
from faithdiff_tpu_torch.eval import niqe as tniqe
from faithdiff_tpu_torch.eval import paq2piq as tpaq
from test_clipiqa import _our_configs
from test_maniqa import CFG as MANIQA_CFG
from test_maniqa import TorchMANIQA
from test_musiq import CFG as MUSIQ_CFG
from test_musiq import TorchMUSIQ
from test_paq2piq import TorchRoIPoolModel, _randomize_bn_stats

RNG = np.random.default_rng(0)
IMG = RNG.random((64, 80, 3)).astype(np.float32)
REF = np.clip(IMG + 0.1 * RNG.standard_normal(IMG.shape), 0, 1).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def close(ours, want):
    """fp32 on both sides, sums in another order: 1e-4 * (1 + |ref|)."""
    np.testing.assert_allclose(ours, want, rtol=1e-4, atol=1e-4)


def same_tree(a, b):
    fa, fb = dict(tlpips._flatten(a)), dict(tlpips._flatten(b))
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))


def port_writes_what_jax_reads(build, tree, path, rename=None):
    """The port's writer: the loaded module's tree, saved, read by JAX's
    loader as the same arrays."""
    model = build(tree)
    tlpips.save_lpips_params(tlpips.tree_from_module(model, rename), str(path))
    same_tree(jlpips.load_lpips_params(str(path)), tree)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# LPIPS, DISTS, PaQ-2-PiQ
# ---------------------------------------------------------------------------

_ALEX_IDX = (0, 3, 6, 8, 10)
_VGG_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _vgg_like_sd(idx, chans, seed):
    """torchvision `features.N.weight/bias` of the convs at `idx`."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for i, (cout, k) in zip(idx, chans):
        sd[f"features.{i}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                      / np.sqrt(cin * k * k)).astype(np.float32)
        sd[f"features.{i}.bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        cin = cout
    return sd


_ALEX_CH = [(64, 11), (192, 5), (384, 3), (256, 3), (256, 3)]
_VGG_CH = [(c, 3) for c, n in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
           for _ in range(n)]


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net, tmp_path):
    backbone = _vgg_like_sd(_ALEX_IDX if net == "alex" else _VGG_IDX,
                            _ALEX_CH if net == "alex" else _VGG_CH, 1)
    taps = [c for c, _ in _ALEX_CH] if net == "alex" else [64, 128, 256, 512, 512]
    lin = {f"lin{i}.model.1.weight": RNG.random((1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate(taps)}
    tree = jlpips.convert_lpips(backbone, lin, net)
    same_tree(tlpips.convert_lpips(backbone, lin, net), tree)
    path = str(tmp_path / "lpips.npz")
    jlpips.save_lpips_params(tree, path)
    if net == "vgg":           # AlexNet, the default, is scored in the harness test
        want = jlpips.make_lpips(path, net)(IMG, REF)
        close(tlpips.make_lpips(path, net, device="cpu")(IMG, REF), want)
    port_writes_what_jax_reads(lambda t: tlpips.build_lpips(t, net, "cpu"), tree,
                               tmp_path / "port.npz")


def test_dists_matches_jax(tmp_path):
    sd = _vgg_like_sd(_VGG_IDX, _VGG_CH, 2)
    n = sum(tdists.STAGE_CHANNELS)
    sd["alpha"] = RNG.random((1, n, 1, 1)).astype(np.float32)
    sd["beta"] = RNG.random((1, n, 1, 1)).astype(np.float32)
    tree = jdists.convert_dists(sd)
    same_tree(tdists.convert_dists(sd), tree)
    path = str(tmp_path / "dists.npz")
    jlpips.save_lpips_params(tree, path)
    # (scored end to end in the harness test) the L2 pool alone, odd sizes
    x = RNG.standard_normal((1, 9, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tdists.l2_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jdists.l2_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    port_writes_what_jax_reads(lambda t: tdists.build_dists(t, "cpu"), tree,
                               tmp_path / "port.npz")


def test_paq2piq_matches_jax(tmp_path):
    torch.manual_seed(0)
    tm = TorchRoIPoolModel().eval()
    with torch.no_grad():
        _randomize_bn_stats(tm, np.random.default_rng(7))
    sd = _np_sd(tm)
    tree = jpaq.convert_paq2piq(sd)
    same_tree(tpaq.convert_paq2piq(sd), tree)
    path = str(tmp_path / "paq.npz")
    jlpips.save_lpips_params(tree, path)
    img = np.random.default_rng(3).integers(0, 256, (64, 96, 3), np.uint8)
    # the picture score is held in the harness test; here the RoI branch
    jtree = jax.tree.map(jnp.asarray, tree)
    close(tpaq.roi_scores(tree, img.astype(np.float32) / 255, (2, 3), device="cpu"),
          jpaq.roi_scores(jtree, img.astype(np.float32) / 255, (2, 3)))
    port_writes_what_jax_reads(lambda t: tpaq.build_paq2piq(t, "cpu"), tree,
                               tmp_path / "port.npz")


# ---------------------------------------------------------------------------
# FID: msgpack and .pth files, the 299 resize, the InceptionV3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inception_tree():
    model = tlpips.seeded_init_(tfid.InceptionV3Features(), 0)
    return tlpips.tree_from_module(model)


def test_flax_msgpack_reader_and_writer_match_flax():
    tree = {"a": {"k": RNG.standard_normal((3, 1, 2)).astype(np.float32),
                  "i": np.arange(70000, dtype=np.int32)},
            "s": np.float32(2.5) * np.ones((), np.float32),
            "b": np.zeros((0,), np.float64), "u": np.arange(4, dtype=np.uint8)}
    flat = dict(tlpips._flatten(flax.serialization.msgpack_restore(
        tfid.write_flax_msgpack(tree))))
    for k, v in tlpips._flatten(tree):
        assert flat[k].dtype == v.dtype
        np.testing.assert_array_equal(flat[k], v)
    back = tfid.read_flax_msgpack(flax.serialization.msgpack_serialize(tree))
    for k, v in tlpips._flatten(tree):
        got = dict(tlpips._flatten(back))[k]
        assert got.dtype == v.dtype and got.shape == v.shape
        np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("hw", [(37, 53), (600, 450), (299, 299)])
def test_fid_resize_matches_jax_image_resize(hw):
    img = np.random.default_rng(sum(hw)).random(hw + (3,)).astype(np.float32)
    # the same weights; XLA's multi-operand einsum picks its own contraction
    # order and fuses the sample positions (up to 1.9e-6 apart, 16 ulps at
    # 1.0): 1e-5, as the degradation engine's resize test
    np.testing.assert_allclose(
        tfid.resize_bilinear(torch.from_numpy(img), 299).numpy(),
        jfid._resize_bilinear(img, 299), rtol=0, atol=1e-5)


def test_fid_features_match_jax(inception_tree, tmp_path):
    path = tmp_path / "inception_v3_fid.npz"
    path.write_bytes(flax.serialization.msgpack_serialize(inception_tree))
    imgs = [RNG.random((48, 64, 3)).astype(np.float32) for _ in range(3)]
    want = jfid.make_fid_features(str(path))(imgs)
    ours = tfid.make_fid_features(str(path), batch=2, device="cpu")(imgs)
    assert ours.shape == (3, 2048)
    close(ours, want)
    # the Frechet step (a verbatim copy) on a 64-d slice: scipy's sqrtm of a
    # 2048^2 product takes ~20 s of CPU a call
    a, b = ours[:, :64], ours[::-1, 64:128] * 1.1
    close(tfid.fid_from_features(a, b),
          jfid.fid_from_features(want[:, :64], want[::-1, 64:128] * 1.1))
    # the .pth route: torchvision / pytorch-fid names, converted on load
    pth = tmp_path / "tv.pth"
    sd = tfid.torchvision_state_dict(inception_tree)
    assert "Conv2d_1a_3x3.bn.running_var" in sd and "Mixed_7c.branch_pool.conv.weight" in sd
    sd["fc.weight"] = torch.zeros(4, 2048)                  # dropped on load
    torch.save(sd, pth)
    same_tree(tfid.convert_inception(sd), jfid.convert_inception(sd))
    same_tree(tfid.convert_inception(sd), inception_tree)
    npz = str(tmp_path / "tv.npz")                # absent: the .pth beside it
    close(tfid.make_fid_features(npz, device="cpu")(imgs[:1]), want[:1])


# ---------------------------------------------------------------------------
# MUSIQ, MANIQA, CLIPIQA (tiny configs in the file's `_config`)
# ---------------------------------------------------------------------------

def test_musiq_matches_jax(tmp_path):
    torch.manual_seed(0)
    sd = _np_sd(TorchMUSIQ(MUSIQ_CFG))
    tree = jmusiq.convert_musiq(sd, MUSIQ_CFG)
    tcfg = tmusiq.MUSIQConfig(**dataclasses.asdict(MUSIQ_CFG))
    same_tree(tmusiq.convert_musiq(sd, tcfg), tree)
    path = str(tmp_path / "musiq.npz")
    jmusiq.save_musiq_weights(tree, path, MUSIQ_CFG)
    for img in (IMG, RNG.random((200, 300, 3)).astype(np.float32)):
        toks, jtoks = tmusiq.tokenize_multiscale(img, tcfg), \
            jmusiq.tokenize_multiscale(img, MUSIQ_CFG)
        for a, b in zip(toks, jtoks):
            np.testing.assert_array_equal(a, b)
    # (scored end to end in the harness test)
    model = tmusiq.build_musiq(tree, tcfg, "cpu")
    tmusiq.save_musiq_weights(tlpips.tree_from_module(model), str(tmp_path / "p.npz"),
                              tcfg)
    back = jlpips.load_lpips_params(str(tmp_path / "p.npz"))
    assert tlpips.config_from_blob(jmusiq.MUSIQConfig, back.pop("_config")) == MUSIQ_CFG
    same_tree(back, tree)


@pytest.mark.parametrize("hw", [(40, 56), (17, 23), (331, 97)])
def test_musiq_arp_resize_is_pillow_bilinear(hw):
    img = np.random.default_rng(hw[0]).random(hw + (3,)).astype(np.float32)
    for side in (384, 224, 24):
        np.testing.assert_array_equal(tmusiq._arp_resize(img, side),
                                      jmusiq._arp_resize(img, side))


def test_maniqa_matches_jax(tmp_path):
    torch.manual_seed(0)
    sd = _np_sd(TorchMANIQA(MANIQA_CFG))
    tree = jmaniqa.convert_maniqa(sd, MANIQA_CFG)
    tcfg = tmaniqa.MANIQAConfig(**dataclasses.asdict(MANIQA_CFG))
    same_tree(tmaniqa.convert_maniqa(sd, tcfg), tree)
    path = str(tmp_path / "maniqa.npz")
    jmaniqa.save_maniqa_weights(tree, path, MANIQA_CFG)
    # (scored end to end in the harness test; the upsize below)
    model = tmaniqa.build_maniqa(tree, tcfg, "cpu")
    port_writes_what_jax_reads(lambda t: model, tree, tmp_path / "port.npz")


def test_maniqa_upsize_is_pillow_bicubic():
    img = RNG.random((150, 100, 3)).astype(np.float32)
    crops = tmaniqa.five_crops(img, 224)
    up = np.asarray(Image.fromarray(np.uint8(img * 255)).resize((224, 224),
                                                               Image.BICUBIC))
    np.testing.assert_array_equal(crops[0], up.astype(np.float32) / 255.0)


_CLIP_NAMES = (("vision.vision_model.", "vision_model."),
               ("vision.post_layernorm.", "vision_model.post_layernorm."),
               ("vision.visual_projection.", "visual_projection."),
               ("text.text_model.", "text_model."),
               ("text.text_projection.", "text_projection."))


def clip_model_state_dict(seed=0):
    """A transformers `CLIPModel` state dict at the JAX tests' tiny configs
    (without `position_ids`), seeded: the port's CLIP modules carry
    transformers' names under `vision.` / `text.` (importing transformers
    would cost ~30 s)."""
    vision, text = _our_configs()
    model = tlpips.seeded_init_(tclip.CLIPIQA(
        tclip.CLIPVisionConfig(**dataclasses.asdict(vision)),
        tclip.CLIPTextConfig(**dataclasses.asdict(text)), 99), seed)
    sd = {}
    for k, v in model.state_dict().items():
        for ours, theirs in _CLIP_NAMES:
            k = k.replace(ours, theirs)
        sd[k] = v.numpy()
    return sd


def _clip_file(tmp_path, **prompts):
    sd = clip_model_state_dict()
    tree = jclip.convert_clip_model(sd)
    same_tree(tclip.convert_clip_model(sd), tree)
    vision, text = _our_configs()
    path = str(tmp_path / "clipiqa.npz")
    jclip.save_clipiqa_weights(tree, path, vision, text, eos_token_id=99, **prompts)
    return tree, path


def test_clipiqa_matches_jax(tmp_path):
    ids = np.asarray([[1, 5, 6, 7, 8, 9, 10, 99], [1, 5, 6, 7, 8, 9, 11, 99]], np.int32)
    tree, path = _clip_file(tmp_path, prompt_ids=ids)
    img = (RNG.random((40, 33, 3)) * 255).astype(np.uint8)
    # the prompt-id path at 512 is scored in the harness test; here the
    # CLIPIQA+ embeddings and the 2x2 position grid resized down
    pe = RNG.standard_normal((2, 24)).astype(np.float32)
    close(tclip.make_clipiqa(path, prompt_embeds=pe, resolution=21, device="cpu")(img),
          jclip.make_clipiqa(path, prompt_embeds=pe, resolution=21)(img))
    vision, text = _our_configs()
    tv, tt = (tclip.CLIPVisionConfig(**dataclasses.asdict(vision)),
              tclip.CLIPTextConfig(**dataclasses.asdict(text)))
    model = tclip.build_clipiqa(tree, tv, tt, 99, "cpu")
    tclip.save_clipiqa_weights(tclip.clipiqa_tree(model), str(tmp_path / "p.npz"),
                               tv, tt, eos_token_id=99, prompt_ids=ids)
    back = jlpips.load_lpips_params(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(back.pop("_prompt_ids"), ids)
    back.pop("_config")
    same_tree(back, tree)


def test_clipiqa_position_grid_resize_matches_jax():
    pos = RNG.standard_normal((5, 5, 8)).astype(np.float32)
    for size in ((9, 9), (3, 3), (7, 4)):
        want = jax.image.resize(jnp.asarray(pos), size + (8,), method="bilinear")
        got = tclip.resize(torch.from_numpy(pos)[None], size, "area")[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# NIQE, PSNR, SSIM
# ---------------------------------------------------------------------------

def test_niqe_copy_matches_jax(tmp_path):
    imgs = [(RNG.random((200, 210, 3)) * 255).astype(np.uint8) for _ in range(2)]
    path = str(tmp_path / "niqe.npz")
    tniqe.fit_niqe_params(imgs, save_path=path)
    mu, cov = jniqe.fit_niqe_params(imgs)
    tmu, tcov, patch = tniqe.load_niqe_params(path)
    np.testing.assert_allclose(tmu, mu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tcov, cov, rtol=1e-9, atol=1e-12)
    img = RNG.random((192, 200, 3)).astype(np.float32)
    np.testing.assert_allclose(tniqe.make_niqe_metric(path)(img),
                               jniqe.make_niqe_metric(path)(img), rtol=1e-9)


def test_psnr_ssim_mse_match_jax():
    a, b = IMG, REF
    for fn in ("psnr", "ssim", "mse"):
        want = float(getattr(jmetrics, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tmetrics, fn)(torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
