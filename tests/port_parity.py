"""Helpers shared by the `test_torch_*` parity tests: flax params made with
numpy, NHWC <-> NCHW conversions between the two packages, and a LLaMA
SentencePiece vocabulary with transformers' fast tokenizer of it."""
import collections
import functools

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


@functools.lru_cache(maxsize=1)
def tiny_restore_params():
    """Flax params of the JAX package's tiny UNet, VAE and denoise encoder,
    made with numpy (seeds 0, 1, 2). Made once a process (tracing the three
    inits takes seconds); callers do not change them in place."""
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


def llama_pieces(corpus: str, n_merges: int = 300):
    """A LLaMA-like SentencePiece vocabulary, (piece, score, type) in id
    order: `<unk>` / `<s>` / `</s>` at 0 / 1 / 2, 256 byte pieces, the
    merges of a BPE trained on the words of `corpus` (by score), then its
    single characters."""
    from faithdiff_tpu_torch.captioner.llama_tokenizer import (BYTE, CONTROL,
                                                               NORMAL, UNKNOWN)

    words = collections.Counter("▁" + w for w in corpus.replace("\n", " ").split(" ") if w)
    segs = {w: list(w) for w in words}
    merged = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, s in segs.items():
            for a, b in zip(s, s[1:]):
                pairs[(a, b)] += words[w]
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merged.append(a + b)
        for w, s in segs.items():
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and (s[i], s[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            segs[w] = out
    merged = list(dict.fromkeys(merged))
    chars = sorted({c for w in words for c in w} - set(merged))
    return ([("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
            + [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
            + [(m, -float(i), NORMAL) for i, m in enumerate(merged)]
            + [(c, -float(len(merged) + i), NORMAL) for i, c in enumerate(chars)])


class _Shim:
    """What `LlamaConverter` reads of a slow tokenizer."""

    def __init__(self, path, legacy, add_prefix_space):
        from transformers.utils.sentencepiece_model_pb2_new import ModelProto

        self.vocab_file, self.legacy = path, legacy
        self.add_prefix_space = add_prefix_space
        with open(path, "rb") as f:
            self.proto = ModelProto.FromString(f.read())

    def convert_ids_to_tokens(self, i):
        return self.proto.pieces[i].piece


class _Extractor:
    def __init__(self, path):
        from transformers.utils.sentencepiece_model_pb2_new import ModelProto

        with open(path, "rb") as f:
            self.proto = ModelProto.FromString(f.read())

    def extract(self, vocab_scores=None):
        from transformers.convert_slow_tokenizer import generate_merges

        vocab = {p.piece: i for i, p in enumerate(self.proto.pieces)}
        return vocab, generate_merges(vocab, vocab_scores)


def fast_llama_tokenizer(path: str, legacy: bool = True,
                         add_dummy_prefix: bool = True):
    """transformers' `LlamaTokenizerFast` of a `tokenizer.model`, converted
    as `from_pretrained` converts the slow tokenizer, without
    `sentencepiece`: `LlamaConverter` over a shim with `vocab_file` and
    `convert_ids_to_tokens`, its `SpmExtractor` taking the vocabulary from
    the proto (read by protobuf) and the merges from `generate_merges`."""
    from transformers import LlamaTokenizerFast
    from transformers.convert_slow_tokenizer import LlamaConverter

    class Converter(LlamaConverter):
        SpmExtractor = _Extractor

    return LlamaTokenizerFast(
        tokenizer_object=Converter(_Shim(path, legacy, add_dummy_prefix)).converted(),
        legacy=legacy, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
        add_bos_token=True, add_eos_token=False)
