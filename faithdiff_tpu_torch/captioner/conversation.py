"""Conversation templates for the captioner (the port's own copy of
`faithdiff_tpu/captioner/conversation.py`, which imports no JAX; the port
imports nothing of the JAX package).

Capability-equivalent to LLaVA's `llava/conversation.py:9-396`:
the `Conversation` dataclass, separator styles SINGLE / TWO / MPT /
LLAMA_2 / PLAIN, and the full template registry (16 names over 12 distinct
templates). The FaithDiff path uses `vicuna_v1` (`llava/llm_agent.py:19`);
the others exist for checkpoint compatibility with differently-finetuned
captioners (the template must match the finetune or generations degrade).

`mmtag` versions wrap the image as `<Image><image></Image>` in a dedicated
first exchange (reference `get_prompt`, `llava/conversation.py:34-43`).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    LLAMA_2 = enum.auto()
    PLAIN = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[Tuple[str, Optional[str]]]
    sep_style: SeparatorStyle
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "unknown"
    offset: int = 0  # few-shot messages to skip when displaying history

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        """Render the transcript (reference `get_prompt`,
        `llava/conversation.py:32-107`; the tuple-message image packing is
        handled by `build_prompt` here instead)."""
        msgs = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in msgs:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(msgs):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            # roles carry their own "<|im_start|>role\n" framing
            ret = self.system + self.sep
            for role, message in msgs:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            ret = ""
            for i, (role, message) in enumerate(msgs):
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + f"[INST] {message} [/INST]"
                    else:
                        ret += " " + message + " " + self.sep2
            # the reference lstrips the leading bos sep (`:93`)
            return ret.lstrip(self.sep) if self.sep else ret
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2 if self.sep2 is not None else self.sep]
            ret = self.system
            for i, (_, message) in enumerate(msgs):
                if message:
                    ret += message + seps[i % 2]
            return ret
        raise ValueError(self.sep_style)

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles, list(self.messages),
                            self.sep_style, self.sep, self.sep2,
                            self.version, self.offset)


_VICUNA_V0_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions.")
_VICUNA_V1_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions.")
_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant is able to understand the visual content "
    "that the user provides, and assist the user with a variety of tasks "
    "using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.")

# one-exchange energy-sources few-shot carried by vicuna_v0
# (`llava/conversation.py:211-240`) — kept short here: the reference's long
# canned answer only matters for v0 checkpoints, which ship their own text.
_V0_FEWSHOT: List[Tuple[str, Optional[str]]] = []

conv_vicuna_v0 = Conversation(
    system=_VICUNA_V0_SYSTEM, roles=("Human", "Assistant"),
    messages=list(_V0_FEWSHOT), sep_style=SeparatorStyle.SINGLE, sep="###",
    version="v0", offset=len(_V0_FEWSHOT))
conv_vicuna_v1 = Conversation(
    system=_VICUNA_V1_SYSTEM, roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1")
conv_llama_2 = Conversation(
    system=(
        "You are a helpful, respectful and honest assistant. Always answer "
        "as helpfully as possible, while being safe.  Your answers should "
        "not include any harmful, unethical, racist, sexist, toxic, "
        "dangerous, or illegal content. Please ensure that your responses "
        "are socially unbiased and positive in nature.\n\n"
        "If a question does not make any sense, or is not factually "
        "coherent, explain why instead of answering something not correct. "
        "If you don't know the answer to a question, please don't share "
        "false information."),
    roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
    version="llama_v2")
conv_llava_llama_2 = Conversation(
    system=("You are a helpful language and vision assistant. You are able "
            "to understand the visual content that the user provides, and "
            "assist the user with a variety of tasks using natural "
            "language."),
    roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
    version="llama_v2")
conv_mpt = Conversation(
    system=("<|im_start|>system\nA conversation between a user and an "
            "LLM-based AI assistant. The assistant gives helpful and "
            "honest answers."),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[],
    sep_style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")
conv_llava_plain = Conversation(
    system="", roles=("", ""), messages=[],
    sep_style=SeparatorStyle.PLAIN, sep="\n", version="plain")
conv_llava_v0 = Conversation(
    system=_VICUNA_V0_SYSTEM, roles=("Human", "Assistant"), messages=[],
    sep_style=SeparatorStyle.SINGLE, sep="###", version="v0")
conv_llava_v0_mmtag = Conversation(
    system=_MMTAG_SYSTEM, roles=("Human", "Assistant"), messages=[],
    sep_style=SeparatorStyle.SINGLE, sep="###", version="v0_mmtag")
conv_llava_v1 = Conversation(
    system=_VICUNA_V0_SYSTEM, roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1")
conv_llava_v1_mmtag = Conversation(
    system=_MMTAG_SYSTEM, roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1_mmtag")
conv_mistral_instruct = Conversation(
    system="", roles=("USER", "ASSISTANT"), messages=[],
    sep_style=SeparatorStyle.LLAMA_2, sep="", sep2="</s>",
    version="llama_v2")
conv_chatml_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[],
    sep_style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")

default_conversation = conv_vicuna_v1

# registry names mirror `llava/conversation.py:373-391`
TEMPLATES = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "chatml_direct": conv_chatml_direct,
    "mistral_direct": conv_chatml_direct,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
conv_templates = TEMPLATES  # reference-compatible alias


def build_prompt(template: str, question: str,
                 image_token: str = "<image>") -> str:
    """One-turn prompt with the image placeholder, ready to split on
    `image_token` for the embedding splice. mmtag templates wrap the image
    in a dedicated `<Image>...</Image>` exchange first (reference
    `get_prompt` tuple-message path, `llava/conversation.py:34-43`)."""
    conv = TEMPLATES[template].copy()
    if "mmtag" in conv.version:
        conv.append_message(conv.roles[0], f"<Image>{image_token}</Image>")
        conv.append_message(conv.roles[1], "Received.")
        conv.append_message(conv.roles[0], question)
    else:
        conv.append_message(conv.roles[0], f"{image_token}\n{question}")
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()
