"""Caption agent: the LLaVA-1.5 path from an image to its caption, vision
tower + projector + LM decode (counterpart of
`faithdiff_tpu/captioner/agent.py`). The LM is LLaMA (Mistral), MPT, or
DeepSeek-V3 (Kimi-VL-A3B's LM, `deepseek_v3.py`), built by
`build_caption_agent` from its config's type.

The vicuna_v1 conversation with an `<image>` slot, the fixed question
"Describe this image and its style in a very detailed manner.", sampling at
temperature 0.2 / top-p 0.7, at most 512 new tokens. The tokenizer is any
object with the HF call interface (`tok(text, add_special_tokens=...,
return_tensors="np").input_ids`, `tok.decode(ids, skip_special_tokens=True)`,
`tok.eos_token_id`).

`CaptionAgent.from_checkpoint` loads what `utils/convert_cli.py --llava
--clip_vision` writes from the reference's released files (`llama/`,
`projector/`, `vision/` of safetensors files, `tokenizer/` with LLaMA's
`tokenizer.model`, an optional PEFT-style `lora/`), quantising each LLaMA
projection on the card as it is read. `build_caption_agent` makes the
models on the card with seeded random weights instead.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..utils.profiling import span
from .clip_vision import (CLIPVisionConfig, CLIPVisionTower, VisionProjector,
                          preprocess_clip_image, process_anyres_image)
from .conversation import build_prompt
from .deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM
from .llama import (LlamaConfig, LlamaForCausalLM, greedy_generate,
                    is_quantized_projection, quantize_projection,
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

    @staticmethod
    @torch.no_grad()
    def from_checkpoint(ckpt_dir: str, dtype: torch.dtype = torch.bfloat16,
                        load_8bit: bool = True, load_4bit: bool = False,
                        model_type: str = "", device="cuda",
                        llama_config=None,
                        vision_config: Optional[CLIPVisionConfig] = None,
                        ) -> "CaptionAgent":
        """The captioner of a converted checkpoint directory (`llama/`,
        `projector/`, `vision/`, `tokenizer/`; an optional `lora/` adapter
        is merged into the LM weights in fp32 before they are quantised, as
        the reference builder merges it, `llava/model/builder.py:48-90`).

        `model_type` in {"llama", "mistral", "mpt"}; empty infers it from
        the directory's name as the JAX package does. `load_4bit` quantises
        the LM projections to NF4 (it takes precedence), else `load_8bit`
        to int8; MPT is never quantised. Each projection is read from the
        memory-mapped file, moved to `device`, merged, quantised there and
        freed, so the full-precision LM is never whole on the card; the
        buffers equal `quantize_llama_params` of the whole state dict.
        `llama_config` / `vision_config` replace LLaVA-1.5-13B's (or
        Mistral-7B's, MPT's) and ViT-L/14-336's configs, for tests at a
        small size. Raises if `device` is CUDA and no card is there."""
        from ..utils.safetensors import load_dir
        from .llama_tokenizer import LlamaTokenizer

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CaptionAgent.from_checkpoint: device 'cuda' requested "
                               "but CUDA is not available (pass device='cpu')")
        if not model_type:
            name = os.path.basename(os.path.normpath(ckpt_dir)).lower()
            model_type = ("mpt" if "mpt" in name
                          else "mistral" if "mistral" in name else "llama")
        quant = "nf4" if load_4bit else ("int8" if load_8bit else "")
        vision_config = vision_config or CLIPVisionConfig()
        with device:
            if model_type == "mpt":
                from .mpt import MPTConfig, MPTForCausalLM

                quant = ""
                llama = MPTForCausalLM(llama_config or MPTConfig(), dtype=dtype)
                hidden = llama.config.d_model
            else:
                base = llama_config or (LlamaConfig.mistral_7b() if model_type == "mistral"
                                        else LlamaConfig.llava_13b())
                llama = LlamaForCausalLM(dataclasses.replace(base, quant=quant),
                                         dtype=dtype)
                hidden = llama.config.hidden_size
            vision = CLIPVisionTower(vision_config, dtype=dtype)
            projector = VisionProjector(hidden, vision_config.hidden_size, dtype=dtype)
        lora_dir = os.path.join(ckpt_dir, "lora")
        lora = load_dir(lora_dir) if os.path.exists(lora_dir) else None
        state = load_dir(os.path.join(ckpt_dir, "llama"))
        load_quantized_(llama, state, quant, lora)
        del state
        vision.load_state_dict(load_dir(os.path.join(ckpt_dir, "vision")), strict=True)
        projector.load_state_dict(load_dir(os.path.join(ckpt_dir, "projector")),
                                  strict=True)
        for model in (llama, vision, projector):
            model.eval().requires_grad_(False)
        return CaptionAgent(llama=llama, vision=vision, projector=projector,
                            tokenizer=LlamaTokenizer.from_pretrained(
                                os.path.join(ckpt_dir, "tokenizer")))

    @property
    def device(self) -> torch.device:
        return next(self.llama.parameters()).device

    def _embed_ids(self, ids: np.ndarray) -> torch.Tensor:
        return self.llama.embed(torch.from_numpy(np.asarray(ids, np.int64)).to(self.device))

    def _image_features(self, pixels: np.ndarray) -> torch.Tensor:
        with span("caption.vision", images=pixels.shape[0]):
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
        `seed` on the models' device. Span `caption` (`images`) around it
        all, with `caption.vision`, `caption.prefill` and `caption.decode`
        inside."""
        n = 1 if isinstance(images, np.ndarray) and images.ndim == 3 else len(images)
        with span("caption", images=n):
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
def load_quantized_(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                    quant: str, lora: Optional[Mapping[str, torch.Tensor]] = None,
                    ) -> None:
    """Load a full-precision LM state dict into `model` (built with
    `quant`), strictly: each projection is moved to the model's device,
    merged with its `lora` adapter if it has one (`training.lora`), and
    quantised there by `quantize_projection`; every other entry is copied
    in and cast to its parameter's dtype."""
    from ..training.lora import lora_targets, merge_lora

    targets: Dict[str, torch.Tensor] = dict(model.state_dict())
    device = next(iter(targets.values())).device
    adapted = set(lora_targets(lora)) if lora else set()
    absent = sorted(adapted - set(state_dict))
    if absent:
        raise KeyError(f"LoRA adapters for weights the checkpoint lacks: {absent[:3]}")
    for key in sorted(state_dict):
        value = state_dict[key]
        if key in adapted or is_quantized_projection(key, quant):
            value = value.to(device)                 # merged and quantised there
        if key in adapted:
            value = merge_lora({key: value}, lora)[key]
        for name, tensor in quantize_projection(key, value, quant).items():
            if name not in targets:
                raise KeyError(f"unexpected key in the checkpoint: {name}")
            target = targets.pop(name)
            if tuple(target.shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(tensor.shape)}, "
                                 f"model {tuple(target.shape)}")
            target.copy_(tensor)
        del value
    if targets:
        raise KeyError(f"missing keys in the checkpoint: {sorted(targets)[:5]}")


@torch.no_grad()
def build_caption_agent(
    tokenizer: Any,
    llama_config=LlamaConfig(quant="nf4"),
    vision_config: CLIPVisionConfig = CLIPVisionConfig(),
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    seed: int = 0,
    init: bool = True,
) -> CaptionAgent:
    """LLaVA-1.5 captioner on `device` in `dtype` (13B, nf4 by default; a
    `DeepseekV3Config` gives the DeepSeek-V3 LM), with seeded random
    weights from a generator on the device: weight matrices N(0, 1/fan_in)
    (the model's own `random_init_` where it has one), biases 0, norm
    weights 1, and each quantised projection drawn in bf16 and quantised at
    once. With `init` False the weights are left unset on the device (built
    on the meta device, then given memory) for a caller that loads or draws
    every one of them."""
    from ..pipelines.factory import random_init_

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_caption_agent: device 'cuda' requested but CUDA "
                           "is not available (pass device='cpu' to run on the CPU)")
    lm_class = (DeepseekV3ForCausalLM if isinstance(llama_config, DeepseekV3Config)
                else LlamaForCausalLM)
    with device if init else torch.device("meta"):
        llama = lm_class(llama_config, dtype=dtype)
        vision = CLIPVisionTower(vision_config, dtype=dtype)
        projector = VisionProjector(llama_config.hidden_size,
                                    vision_config.hidden_size, dtype=dtype)
    generator = torch.Generator(device=device).manual_seed(seed)
    for model in (llama, vision, projector):
        if not init:
            model.to_empty(device=device)
        elif hasattr(model, "random_init_"):
            model.random_init_(generator)
        else:
            random_init_(model, generator)
        model.eval().requires_grad_(False)
    if init:
        random_init_quantized_(llama, generator)
    return CaptionAgent(llama=llama, vision=vision, projector=projector,
                        tokenizer=tokenizer)
