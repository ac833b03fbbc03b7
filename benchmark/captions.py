"""What the caption-then-restore cells make from the seed besides the
restore's weights and images: the captioner's weights, each tensor drawn
from a seed of its own, and the two synthetic vocabularies.

- `draw(seed, part, name, shape, device)`: one tensor of network `part`
  ("lm", "vision", "projector", "text_encoders") in bf16 from a
  `torch.Generator` on `device` seeded from (seed, part, name): matrices
  and kernels N(0, 1/fan_in) (fan_in the product of the axes after the
  first; the LM's last axis, so the stacked experts' too), 1-D weights
  (norm scales) 1 + N(0, 0.1^2), other 1-D tensors (biases, the class
  embedding, the router's correction bias) N(0, 0.05^2). The program and
  the reference draw the same bits, so the reference can make one LM layer
  at a time.
- `CaptionVocab`: the LM's tokenizer over a seeded synthetic vocabulary
  whose every id is a lower-case word of up to three letters (about one in
  twelve ending a sentence), which the SDXL vocabulary of `write_sdxl_vocab`
  spells in one to three tokens, so that a caption becomes a prompt through
  `trim_caption` and the SDXL tokenizers. Text is split on spaces and each
  word hashed to an id; `<s>` is id 1, and `</s>` (eos) is `vocab_size`,
  an id that no sample takes, so every caption runs `max_new_tokens`.
- `write_sdxl_vocab(root)`: SDXL-layout `tokenizer/` and `tokenizer_2/`
  over a synthetic 49,408-symbol BPE vocabulary (the 256 byte symbols, the
  same with `</w>`, merges that build lower-case words of up to four
  letters, `<|startoftext|>`, `<|endoftext|>`), as the port's chip smoke
  test writes them.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, List

import numpy as np
import torch

LETTERS = "etaoinshrdlcumwfgypbvkjxqz"
SDXL_VOCAB = 49408


def part_seed(seed: int, part: str, name: str) -> int:
    digest = hashlib.blake2b(f"{int(seed)}/{part}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") % (1 << 63)


@torch.no_grad()
def draw(seed: int, part: str, name: str, shape, device) -> torch.Tensor:
    shape = tuple(shape)
    gen = torch.Generator(device=device).manual_seed(part_seed(seed, part, name))
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    if len(shape) >= 2:
        fan_in = shape[-1] if part == "lm" else int(np.prod(shape[1:]))
        return t.mul_(fan_in ** -0.5)
    if name.endswith("weight"):
        return t.mul_(0.1).add_(1.0)
    return t.mul_(0.05)


@torch.no_grad()
def fill_(seed: int, part: str, module: torch.nn.Module) -> None:
    """Every parameter of `module` drawn in place (cast to its dtype)."""
    for name, p in module.named_parameters():
        p.copy_(draw(seed, part, name, p.shape, p.device))


def sdxl_words() -> List[str]:
    """The lower-case words of up to three letters, in the order the
    synthetic SDXL vocabulary's merges build them."""
    words, seen, out = list(LETTERS), set(LETTERS), list(LETTERS)
    for word in words:
        if len(word) >= 3:
            continue
        for b in LETTERS:
            token = word + b
            if token not in seen:
                seen.add(token)
                words.append(token)
                out.append(token)
    return out


def write_sdxl_vocab(root: str) -> str:
    from faithdiff_tpu_torch.models.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    n_merges = SDXL_VOCAB - 2 * 256 - 2
    merges, words, seen = [], list(LETTERS), set(vocab)
    for word in words:
        for b in LETTERS:
            for second in (b, b + "</w>"):
                token = word + second
                if token not in seen and len(merges) < n_merges:
                    seen.add(token)
                    merges.append(f"{word} {second}")
                    vocab.append(token)
                    if not second.endswith("</w>"):
                        words.append(token)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    special = {k: {"content": v, "lstrip": False, "normalized": True,
                   "rstrip": False, "single_word": False}
               for k, v in (("bos_token", "<|startoftext|>"),
                            ("eos_token", "<|endoftext|>"),
                            ("unk_token", "<|endoftext|>"))}
    for name, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump({t: i for i, t in enumerate(vocab)}, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
            json.dump(dict(special, pad_token=pad), f)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"model_max_length": 77, "pad_token": pad,
                       "tokenizer_class": "CLIPTokenizer"}, f)
    return root


class _Ids:
    def __init__(self, ids):
        self.input_ids = ids


class CaptionVocab:
    """The LM's tokenizer with the HF call interface the caption agent uses
    (`tok(text, add_special_tokens=..., return_tensors="np").input_ids`,
    `decode`, `eos_token_id`)."""

    BOS = 1

    def __init__(self, vocab_size: int, seed: int):
        words = sdxl_words()
        rng = np.random.default_rng([int(seed) % (1 << 63), 0xC0DE])
        pick = rng.integers(0, len(words), vocab_size)
        stop = rng.random(vocab_size) < 1 / 12
        self.words = [words[j] + ("." if s else "") for j, s in zip(pick, stop)]
        self.vocab_size = vocab_size
        self.eos_token_id = vocab_size

    def _id(self, word: str) -> int:
        if word == "<s>":
            return self.BOS
        if word == "</s>":
            return self.eos_token_id
        digest = hashlib.blake2b(word.encode(), digest_size=8).digest()
        return 2 + int.from_bytes(digest, "little") % (self.vocab_size - 2)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self._id(w) for w in text.split()]
        return [self.BOS] + ids if add_special_tokens else ids

    def __call__(self, text: str, add_special_tokens: bool = True, return_tensors=None):
        ids = self.encode(text, add_special_tokens)
        return _Ids(np.asarray([ids], np.int64) if return_tensors == "np" else ids)

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        special = {self.BOS, self.eos_token_id}
        return " ".join(self.words[int(i)] for i in ids
                        if not (skip_special_tokens and int(i) in special)
                        and 0 <= int(i) < self.vocab_size)
