"""Captioner training data utilities (the port's own copy of
`faithdiff_tpu/training/caption_data.py`, which imports no JAX; the port
imports nothing of the JAX package). Samplers take a numpy `Generator`, as
the JAX package's do, so one seed gives one order in both.

Capability-equivalent to the reference's LLaVA trainer data machinery:
- length-grouped / modality-grouped sampling
  (`llava/train/llava_trainer.py:38-130`)
- `tokenizer_image_token` (`llava/mm_utils.py:185-214`)
- conversation-format preprocessing with assistant-only supervision
  (`llava/train/train.py:398-510`, the v1/TWO-separator template family)

Pure host-side (numpy + tokenizer); the train step consumes the resulting
(input_ids, labels) arrays.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200


# ---------------------------------------------------------------------------
# grouped sampling
# ---------------------------------------------------------------------------

def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Greedy equal-total-length split (`llava_trainer.py:38-58`)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    totals = [0.0] * num_chunks
    for idx in indices:
        shortest = totals.index(min(totals))
        chunks[shortest].append(idx)
        totals[shortest] += lengths[idx]
        if len(chunks[shortest]) == per_chunk:
            totals[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: Optional[np.random.Generator] = None
                               ) -> List[int]:
    """Shuffle -> megabatches sorted by length desc -> even per-rank chunks
    (`llava_trainer.py:88-97`)."""
    rng = rng or np.random.default_rng(0)
    indices = rng.permutation(len(lengths)).tolist()
    mb = world_size * batch_size
    megabatches = [indices[i:i + mb] for i in range(0, len(lengths), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
    lengths: Sequence[int], batch_size: int, world_size: int,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Positive lengths = multimodal, negative = language-only; megabatches
    never mix modalities (`llava_trainer.py:60-86`)."""
    rng = rng or np.random.default_rng(0)
    if any(l == 0 for l in lengths):
        raise ValueError("Should not have zero length.")
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_indices, mm_lengths = zip(*mm)
    lang_indices, lang_lengths = zip(*lang)
    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, np.random.default_rng(0))]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, np.random.default_rng(0))]
    mb = world_size * batch_size
    mm_mb = [mm_shuffle[i:i + mb] for i in range(0, len(mm_shuffle), mb)]
    lang_mb = [lang_shuffle[i:i + mb]
               for i in range(0, len(lang_shuffle), mb)]
    additional = mm_mb[-1] + lang_mb[-1] if (mm_mb and lang_mb) else []
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    order = rng.permutation(len(megabatches)).tolist()
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterable of dataset indices grouping similar lengths per megabatch
    (`llava_trainer.py:100-130`)."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int],
                 rng: Optional[np.random.Generator] = None,
                 group_by_modality: bool = False):
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths)
        self.rng = rng
        self.group_by_modality = group_by_modality

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self):
        fn = (get_modality_length_grouped_indices if self.group_by_modality
              else get_length_grouped_indices)
        return iter(fn(self.lengths, self.batch_size, self.world_size,
                       self.rng))


# ---------------------------------------------------------------------------
# conversation preprocessing
# ---------------------------------------------------------------------------

def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Tokenise around `<image>`, inserting the sentinel id
    (`llava/mm_utils.py:185-214`)."""
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    offset = 0
    ids: List[int] = []
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, ch in enumerate(chunks):
        merged.append(ch)
        if i != len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])
    return ids


def preprocess_conversation(
    turns: Sequence[Tuple[str, str]],
    tokenizer,
    template: str = "vicuna_v1",
    has_image: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(user, assistant) turn pairs -> (input_ids, labels) with everything
    except assistant replies masked to IGNORE_INDEX (`train.py:432-497`,
    the v1 / SeparatorStyle.TWO path used by LLaVA-1.5)."""
    from ..captioner.conversation import TEMPLATES, SeparatorStyle

    conv = TEMPLATES[template].copy()
    if conv.sep_style != SeparatorStyle.TWO:
        raise ValueError("assistant-masking implemented for the "
                         "TWO-separator family")
    for user, assistant in turns:
        conv.append_message(conv.roles[0], user)
        conv.append_message(conv.roles[1], assistant)
    conversation = conv.get_prompt()

    tok = (lambda s: tokenizer_image_token(s, tokenizer)) if has_image \
        else (lambda s: tokenizer(s).input_ids)
    input_ids = np.asarray(tok(conversation), np.int64)
    labels = input_ids.copy()

    sep = conv.sep + conv.roles[1] + ": "
    rounds = conversation.split(conv.sep2)
    cur = 1
    labels[:cur] = IGNORE_INDEX
    for i, rou in enumerate(rounds):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        instruction = parts[0] + sep
        round_len = len(tok(rou))
        instruction_len = len(tok(instruction)) - 2
        if i != 0 and not getattr(tokenizer, "legacy", False):
            # modern (non-legacy) tokenizers drop the leading space token
            round_len -= 1
            instruction_len -= 1
        labels[cur:cur + instruction_len] = IGNORE_INDEX
        cur += round_len
    labels[cur:] = IGNORE_INDEX
    return input_ids, labels
