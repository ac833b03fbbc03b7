"""Prompt embeddings for training (counterpart of
`faithdiff_tpu/training/text_embeds.py`).

`cli embed` writes one `<stem>.npz` per caption file (`prompt_embeds`
[77, 2048] and `pooled_embeds` [1280], fp32) and `__null__.npz`, the
empty prompt's embedding that caption dropout substitutes.
`PromptEmbedProvider` supplies a batch's embeddings by sample stem: from
such a directory, from the text towers run live per unique caption, or
zeros; a dropped caption ("") always maps to the null prompt's embedding.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

NULL_KEY = "__null__"

_GetFn = Callable[[str, str], Tuple[np.ndarray, np.ndarray]]


def trim_caption(caption: str, drop_words: int = 3,
                 keep_sentences: int = 2) -> str:
    """Drop the first `drop_words` words and keep the first
    `keep_sentences` sentences (the trim the reference applies to LLaVA
    captions at training and at inference)."""
    words = caption.split(" ")
    caption = " ".join(words[drop_words:])
    sentences = caption.split(".")
    return ".".join(sentences[:keep_sentences]).strip()


def _host_fp32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def precompute_embeds(caption_files: Sequence[str], save_dir: str, tokenize,
                      encode, trim: bool = True) -> int:
    """Encode each caption file (.txt, or .json with a "caption" field) to
    `<stem>.npz`, skipping those written before, then `__null__.npz`.
    `tokenize(text)` -> (ids_1, ids_2); `encode(ids_1, ids_2)` ->
    (prompt embeds, pooled), each with a batch axis of one. Returns the
    number of files written."""
    os.makedirs(save_dir, exist_ok=True)
    written = 0
    for path in list(caption_files) + [None]:
        if path is None:
            stem, caption = NULL_KEY, ""
        else:
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(path) as f:
                text = f.read().strip()
            if path.endswith(".json"):
                text = json.loads(text).get("caption", "")
            caption = trim_caption(text) if trim else text
        out_path = os.path.join(save_dir, f"{stem}.npz")
        if os.path.exists(out_path) and stem != NULL_KEY:
            continue
        ids_1, ids_2 = tokenize(caption)
        pe, pooled = encode(ids_1, ids_2)
        np.savez(out_path, prompt_embeds=_host_fp32(pe[0]),
                 pooled_embeds=_host_fp32(pooled[0]))
        written += 1
    return written


class PromptEmbedProvider:
    """Per-sample (prompt_embeds, pooled_embeds) for batches; counts the
    lookups that took the null embedding (`null_fraction`)."""

    def __init__(self, get_fn: _GetFn):
        self._get = get_fn
        self.null_consumed = 0
        self.total = 0

    def batch(self, stems: Sequence[str], captions: Sequence[str]
              ) -> Tuple[np.ndarray, np.ndarray]:
        pes, pooleds = [], []
        for stem, cap in zip(stems, captions):
            pe, pooled = self._get(stem, cap)
            self.total += 1
            if cap == "":
                self.null_consumed += 1
            pes.append(pe)
            pooleds.append(pooled)
        return np.stack(pes), np.stack(pooleds)

    @property
    def null_fraction(self) -> float:
        return self.null_consumed / max(self.total, 1)

    @classmethod
    def from_dir(cls, embeds_dir: str) -> "PromptEmbedProvider":
        """Stem-keyed `<stem>.npz` files plus the mandatory `__null__.npz`
        that `cli embed` writes for dropped captions."""
        null_path = os.path.join(embeds_dir, f"{NULL_KEY}.npz")
        if not os.path.exists(null_path):
            raise FileNotFoundError(
                f"{null_path} missing: precompute embeds with "
                "`python -m faithdiff_tpu_torch.cli embed` (it always emits "
                "the null-prompt embedding used for caption dropout)")
        cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

        def load(key: str):
            if key not in cache:
                z = np.load(os.path.join(embeds_dir, f"{key}.npz"))
                cache[key] = (z["prompt_embeds"].astype(np.float32),
                              z["pooled_embeds"].astype(np.float32))
            return cache[key]

        def get(stem: str, caption: str):
            return load(NULL_KEY if caption == "" else stem)

        return cls(get)

    @classmethod
    def from_towers(cls, tokenize, encode, max_cache: int = 8192
                    ) -> "PromptEmbedProvider":
        """Live encoding per unique caption: `tokenize(caption)` ->
        (ids_1, ids_2), `encode(ids_1, ids_2)` -> (prompt embeds, pooled)
        with a batch axis of one (e.g. `models.tokenizer.SDXLTokenizer` and
        `models.clip_text.SDXLTextEncoder`). Cached by caption; "" encodes
        once and is the null embedding."""
        cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

        def get(stem: str, caption: str):
            if caption not in cache:
                if len(cache) >= max_cache:
                    cache.pop(next(iter(cache)))
                ids_1, ids_2 = tokenize(caption)
                pe, pooled = encode(ids_1, ids_2)
                cache[caption] = (_host_fp32(pe[0]), _host_fp32(pooled[0]))
            return cache[caption]

        return cls(get)

    @classmethod
    def zeros(cls, cross_dim: int, pooled_dim: int) -> "PromptEmbedProvider":
        """Unconditional training (no text checkpoint)."""
        pe = np.zeros((77, cross_dim), np.float32)
        pooled = np.zeros((pooled_dim,), np.float32)
        return cls(lambda stem, caption: (pe, pooled))
