"""SDXL's two CLIP tokenizers, without transformers (counterpart of
`faithdiff_tpu/models/tokenizer.py`, which wraps transformers'
`CLIPTokenizer`).

`CLIPBPE` reads a tokenizer directory as `CLIPTokenizer.from_pretrained`
does (`vocab.json`, `merges.txt`, and the special tokens of
`tokenizer_config.json` and `special_tokens_map.json`) and gives the ids of
transformers' slow tokenizer on its path without `ftfy`:

1. the text is split around the special tokens (BOS, EOS, UNK, PAD and
   `added_tokens_decoder`), each of which maps to its own id; SDXL's
   `tokenizer_2` pads with `!`, so a `!` in a prompt is its own token there;
2. each other piece is cleaned as `BasicTokenizer(strip_accents=False,
   do_split_on_punc=False)` cleans it: NUL, U+FFFD and control characters
   dropped, whitespace folded to spaces, CJK ideographs spaced, NFC,
   split on whitespace, lower-cased;
3. the result is cut by CLIP's pattern
   `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`,
   with letters and numbers classed by `unicodedata.category` (L*, N*);
4. each word's UTF-8 bytes go through `bytes_to_unicode`, `</w>` joins its
   last symbol, and the merges of `merges.txt[1 : 49152 - 256 - 2 + 1]`
   apply by rank; unknown symbols take UNK's id.

`SDXLTokenizer` pads or truncates both towers' ids to 77 (BOS ... EOS, then
the directory's pad id), as the reference's `padding="max_length",
truncation=True` does. Standard library only.
"""
from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_BOS, _EOS, _MAX_LEN = 49406, 49407, 77
_NUM_MERGES = 49152 - 256 - 2
_DEFAULT_SPECIALS = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                     "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
# CLIP's pattern before its letter / number classes, case-insensitive as
# there: the text is lower-cased already, but U+017F (long s) still
# matches an `s`, as it does in the `regex` package
_LEAD = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
                   re.IGNORECASE)


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """UTF-8 byte -> printable unicode character, CLIP's reversible map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """BasicTokenizer(strip_accents=False, do_split_on_punc=False), its
    tokens joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def _char_class(ch: str) -> str:
    cat = unicodedata.category(ch)
    if cat[0] in "LN":
        return cat[0]
    return "S" if ch.isspace() else "O"


def clip_words(text: str) -> List[str]:
    """CLIP's pattern over cleaned text: special strings and contractions
    first, then runs of letters, single numbers, runs of the rest;
    whitespace is skipped."""
    words, i, n = [], 0, len(text)
    while i < n:
        m = _LEAD.match(text, i)
        if m:
            words.append(m.group())
            i = m.end()
            continue
        cls = _char_class(text[i])
        if cls == "S":
            i += 1
            continue
        j = i + 1
        if cls != "N":
            while j < n and _char_class(text[j]) == cls:
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class CLIPBPE:
    """One CLIP tokenizer directory: text -> ids without BOS, EOS or pad."""

    def __init__(self, path: str):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:_NUM_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): r for r, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

        # special tokens: tokenizer_config.json, then special_tokens_map.json
        # over it (the order from_pretrained reads them in); an
        # added_tokens_decoder entry gives a token its id and flags
        specials = dict(_DEFAULT_SPECIALS)
        flags: Dict[str, dict] = {}
        decoder: Dict[str, dict] = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            full = os.path.join(path, name)
            if not os.path.exists(full):
                continue
            with open(full, encoding="utf-8") as f:
                cfg = json.load(f)
            for key in _DEFAULT_SPECIALS:
                if cfg.get(key) is not None:
                    specials[key] = _token_content(cfg[key])
                    if isinstance(cfg[key], dict):
                        flags[specials[key]] = cfg[key]
            for idx, tok in cfg.get("added_tokens_decoder", {}).items():
                decoder[tok["content"]] = dict(tok, id=int(idx))
        flags.update(decoder)
        self.added: Dict[str, int] = {}
        self.strip: Dict[str, Tuple[bool, bool]] = {}
        for tok in list(specials.values()) + list(decoder):
            idx = decoder[tok]["id"] if tok in decoder else self.encoder.get(tok)
            if idx is None:
                raise ValueError(f"{path}: special token {tok!r} is not in vocab.json")
            self.added[tok] = idx
            tok_flags = flags.get(tok, {})
            self.strip[tok] = (bool(tok_flags.get("lstrip")),
                               bool(tok_flags.get("rstrip")))
        self.bos_id = self.added[specials["bos_token"]]
        self.eos_id = self.added[specials["eos_token"]]
        self.pad_id = self.added[specials["pad_token"]]
        self.unk_id = self.added[specials["unk_token"]]
        # leftmost, longest special token first (none of CLIP's is a prefix
        # of another, where this equals transformers' trie)
        self._split = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _pieces(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is a special token), split as transformers' trie splits,
        with each special token's lstrip / rstrip applied."""
        pieces, pos = [], 0
        for m in self._split.finditer(text):
            pieces += [[text[pos:m.start()], False], [m.group(), True]]
            pos = m.end()
        pieces.append([text[pos:], False])
        for i, (piece, special) in enumerate(pieces):
            if not special:
                continue
            lstrip, rstrip = self.strip[piece]
            if rstrip and i + 1 < len(pieces):
                pieces[i + 1][0] = pieces[i + 1][0].lstrip()
            if lstrip and i > 0:
                pieces[i - 1][0] = pieces[i - 1][0].rstrip()
        return [(p, s) for p, s in pieces if p]

    def encode(self, text: str) -> List[int]:
        ids = []
        for piece, special in self._pieces(text):
            if special:
                ids.append(self.added[piece])
                continue
            for word in clip_words(basic_clean(piece)):
                word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                for tok in self.bpe(word).split(" "):
                    ids.append(self.added[tok] if tok in self.added
                               else self.encoder.get(tok, self.unk_id))
        return ids

    def __call__(self, text: str, max_len: int = _MAX_LEN) -> List[int]:
        """BOS, the ids truncated to `max_len - 2`, EOS, then pad ids."""
        ids = [self.bos_id] + self.encode(text)[:max_len - 2] + [self.eos_id]
        return ids + [self.pad_id] * (max_len - len(ids))


class SDXLTokenizer:
    """Both towers' tokenizers: `path_1` / `path_2` hold `vocab.json` and
    `merges.txt` each (SDXL's `tokenizer/` and `tokenizer_2/`)."""

    def __init__(self, path_1: str, path_2: Optional[str] = None):
        self.tok_1 = CLIPBPE(path_1)
        self.tok_2 = CLIPBPE(path_2 or path_1)

    def __call__(self, prompts) -> Tuple[np.ndarray, np.ndarray]:
        """str or list of str -> (ids_1, ids_2), each [B, 77] int32."""
        if isinstance(prompts, str):
            prompts = [prompts]
        return tuple(np.asarray([tok(p) for p in prompts], np.int32)
                     for tok in (self.tok_1, self.tok_2))


class HashTokenizer:
    """Deterministic word-hash tokenizer for checkpoint-free smoke runs
    and tests (not CLIP BPE). An empty prompt gives [BOS, EOS, EOS, ...],
    as CLIP pads."""

    def __init__(self, vocab_size: int = 49408, max_len: int = _MAX_LEN):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def _encode_one(self, prompt: str) -> np.ndarray:
        bos = min(_BOS, self.vocab_size - 2)
        eos = min(_EOS, self.vocab_size - 1)
        ids = [bos]
        for w in prompt.split()[: self.max_len - 2]:
            ids.append(zlib.crc32(w.encode()) % max(self.vocab_size - 3, 1) + 1)
        ids.append(eos)
        ids += [eos] * (self.max_len - len(ids))
        return np.asarray(ids, np.int32)

    def __call__(self, prompts) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(prompts, str):
            prompts = [prompts]
        ids = np.stack([self._encode_one(p) for p in prompts])
        return ids, ids


def pad_token_ids(prompt_ids: np.ndarray) -> np.ndarray:
    """[B, <=77] -> [B, 77] padded with EOS (CLIP's pad is its EOS)."""
    b, s = prompt_ids.shape
    if s >= _MAX_LEN:
        return prompt_ids[:, :_MAX_LEN]
    pad = np.full((b, _MAX_LEN - s), _EOS, prompt_ids.dtype)
    return np.concatenate([prompt_ids, pad], axis=1)

