"""The LLaVA-1.5 captioner: CLIP vision tower, projector, LLaMA / MPT
decoders with KV-cache generation, LLaMA's SentencePiece tokenizer, and
the caption agent."""
from .agent import CaptionAgent, build_caption_agent, build_vicuna_prompt
from .clip_vision import CLIPVisionConfig, CLIPVisionTower, VisionProjector
from .llama import LlamaConfig, LlamaForCausalLM, greedy_generate
from .llama_tokenizer import LlamaTokenizer

__all__ = ["CaptionAgent", "build_caption_agent", "build_vicuna_prompt",
           "CLIPVisionConfig", "CLIPVisionTower", "VisionProjector",
           "LlamaConfig", "LlamaForCausalLM", "LlamaTokenizer", "greedy_generate"]
