"""Prompt embeddings precomputed for training (counterpart of
`NULL_KEY` and `precompute_embeds` of `faithdiff_tpu/training/text_embeds.py`).

`cli embed` writes one `<stem>.npz` per caption file (`prompt_embeds`
[77, 2048] and `pooled_embeds` [1280], fp32) and `__null__.npz`, the
empty prompt's embedding that caption dropout substitutes.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

NULL_KEY = "__null__"


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
