"""Caption agent: the LLaVA-1.5 path from an image to its caption, vision
tower + projector + LLaMA decode (counterpart of
`faithdiff_tpu/captioner/agent.py`).

The vicuna_v1 conversation with an `<image>` slot, the fixed question
"Describe this image and its style in a very detailed manner.", sampling at
temperature 0.2 / top-p 0.7, at most 512 new tokens. The tokenizer is any
object with the HF call interface (`tok(text, add_special_tokens=...,
return_tensors="np").input_ids`, `tok.decode(ids, skip_special_tokens=True)`,
`tok.eos_token_id`).

`build_caption_agent` makes the models on the card, in bf16, with seeded
random weights; the LLaMA projections are quantised as they are made.
Loading released weights (`from_checkpoint` in the JAX package) waits for
a checkpoint reader and a tokenizer that need neither orbax nor
transformers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch
import torch.nn as nn

from .clip_vision import (CLIPVisionConfig, CLIPVisionTower, VisionProjector,
                          preprocess_clip_image, process_anyres_image)
from .conversation import build_prompt
from .llama import (LlamaConfig, LlamaForCausalLM, greedy_generate,
                    random_init_quantized_)

DEFAULT_QUESTION = "Describe this image and its style in a very detailed manner."


def build_vicuna_prompt(question: str, template: str = "vicuna_v1") -> List[str]:
    """[text before the image slot, text after it]."""
    pre, post = build_prompt(template, question).split("<image>", 1)
    return [pre, post]


@dataclasses.dataclass
class CaptionAgent:
    """Glues tokenizer + vision tower + projector + LM."""

    llama: nn.Module
    vision: CLIPVisionTower
    projector: VisionProjector
    tokenizer: Any
    temperature: float = 0.2
    top_p: float = 0.7
    max_new_tokens: int = 512

    @property
    def device(self) -> torch.device:
        return next(self.llama.parameters()).device

    def _embed_ids(self, ids: np.ndarray) -> torch.Tensor:
        return self.llama.embed(torch.from_numpy(np.asarray(ids, np.int64)).to(self.device))

    def _image_features(self, pixels: np.ndarray) -> torch.Tensor:
        return self.projector(self.vision(torch.from_numpy(pixels).to(self.device)))

    @torch.no_grad()
    def build_multimodal_embeds(self, images, question: str = DEFAULT_QUESTION,
                                image_aspect_ratio: str = "pad",
                                anyres_grid_pinpoints=None):
        """Tokenise around the image slot and splice the projected image
        features in (`llava/model/llava_arch.py:145-324`).

        `images`: one HWC uint8 array or a list. `image_aspect_ratio`: "pad"
        (expand2square, LLaVA-1.5's default), "square" (plain resize) or
        "anyres" with `anyres_grid_pinpoints`: the base image and the grid
        patches, their features concatenated per sample. Samples of
        different lengths are left-padded to the longest.

        Returns `(embeds [B, L, D], pad_len)`: `pad_len` is an int32 [B]
        tensor of left-pad counts, or None when all samples share a length."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        pre, post = build_vicuna_prompt(question)
        pre_ids = np.asarray(self.tokenizer(pre, return_tensors="np").input_ids)
        post_ids = np.asarray(self.tokenizer(post, add_special_tokens=False,
                                             return_tensors="np").input_ids)
        size = self.vision.config.image_size
        if image_aspect_ratio == "anyres":
            if anyres_grid_pinpoints is None:
                raise ValueError("anyres needs anyres_grid_pinpoints")
            stacks = [process_anyres_image(im, size, anyres_grid_pinpoints)
                      for im in images]
            emb = self._image_features(np.concatenate(stacks))
            per_sample, off = [], 0
            for st in stacks:                  # flat merge: [k, P, D] -> [1, k*P, D]
                per_sample.append(emb[off:off + len(st)].reshape(1, -1, emb.shape[-1]))
                off += len(st)
        else:
            pixels = np.concatenate([
                preprocess_clip_image(im, size, pad_square=image_aspect_ratio == "pad")
                for im in images])
            emb = self._image_features(pixels)
            per_sample = [emb[i:i + 1] for i in range(len(images))]

        pre_e, post_e = self._embed_ids(pre_ids), self._embed_ids(post_ids)
        seqs = [torch.cat([pre_e, e.to(pre_e.dtype), post_e], dim=1) for e in per_sample]
        lens = [sq.shape[1] for sq in seqs]
        max_len = max(lens)
        if all(n == max_len for n in lens):
            return torch.cat(seqs, dim=0), None
        padded = [nn.functional.pad(sq, (0, 0, max_len - n, 0))
                  for sq, n in zip(seqs, lens)]
        pad_len = torch.tensor([max_len - n for n in lens], dtype=torch.int32,
                               device=self.device)
        return torch.cat(padded, dim=0), pad_len

    def _stop_sequences(self):
        """Keyword stopping on the conversation separator `</s>` (the
        reference's KeywordsStoppingCriteria over `conv.sep2`)."""
        seqs = []
        for kw in ("</s>",):
            ids = np.asarray(self.tokenizer(kw, add_special_tokens=False).input_ids).ravel()
            if ids.size:
                seqs.append(tuple(int(t) for t in ids))
        return tuple(seqs)

    @torch.no_grad()
    def caption_batch(self, images, question: str = DEFAULT_QUESTION,
                      seed: int = 0, image_aspect_ratio: str = "pad",
                      anyres_grid_pinpoints=None) -> List[str]:
        """Caption several images in one batched generate; finished samples
        pad with eos. Sampling draws from a `torch.Generator` seeded with
        `seed` on the models' device."""
        embeds, pad_len = self.build_multimodal_embeds(
            images, question, image_aspect_ratio=image_aspect_ratio,
            anyres_grid_pinpoints=anyres_grid_pinpoints)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        result = greedy_generate(
            self.llama, embeds, max_new_tokens=self.max_new_tokens,
            eos_token_id=int(self.tokenizer.eos_token_id or 2),
            temperature=self.temperature, top_p=self.top_p,
            generator=generator, stop_sequences=self._stop_sequences(),
            pad_len=pad_len)
        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        return [self.tokenizer.decode(tokens[i, :int(lengths[i])],
                                      skip_special_tokens=True).strip()
                for i in range(tokens.shape[0])]

    def caption(self, image: np.ndarray, question: str = DEFAULT_QUESTION,
                seed: int = 0) -> str:
        return self.caption_batch([image], question, seed)[0]


@torch.no_grad()
def build_caption_agent(
    tokenizer: Any,
    llama_config: LlamaConfig = LlamaConfig(quant="nf4"),
    vision_config: CLIPVisionConfig = CLIPVisionConfig(),
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    seed: int = 0,
) -> CaptionAgent:
    """LLaVA-1.5 captioner on `device` in `dtype` (13B, nf4 by default),
    with seeded random weights from a generator on the device: weight
    matrices N(0, 1/fan_in), biases 0, norm weights 1, and each quantised
    projection drawn in bf16 and quantised at once."""
    from ..pipelines.factory import random_init_

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_caption_agent: device 'cuda' requested but CUDA "
                           "is not available (pass device='cpu' to run on the CPU)")
    with device:
        llama = LlamaForCausalLM(llama_config, dtype=dtype)
        vision = CLIPVisionTower(vision_config, dtype=dtype)
        projector = VisionProjector(llama_config.hidden_size,
                                    vision_config.hidden_size, dtype=dtype)
    generator = torch.Generator(device=device).manual_seed(seed)
    for model in (llama, vision, projector):
        random_init_(model, generator)
        model.eval().requires_grad_(False)
    random_init_quantized_(llama, generator)
    return CaptionAgent(llama=llama, vision=vision, projector=projector,
                        tokenizer=tokenizer)
