"""The LLaVA-1.5 captioner: CLIP vision tower, projector, LLaMA / MPT /
DeepSeek-V3 (MLA + MoE) decoders with cached generation, LLaMA's
SentencePiece tokenizer, and the caption agent."""
from .agent import CaptionAgent, build_caption_agent, build_vicuna_prompt
from .clip_vision import CLIPVisionConfig, CLIPVisionTower, VisionProjector
from .deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM, greedy_generate
from .llama_tokenizer import LlamaTokenizer

__all__ = ["CaptionAgent", "build_caption_agent", "build_vicuna_prompt",
           "CLIPVisionConfig", "CLIPVisionTower", "VisionProjector",
           "DeepseekV3Config", "DeepseekV3ForCausalLM",
           "LlamaConfig", "LlamaForCausalLM", "LlamaTokenizer", "greedy_generate"]
