"""Interactive captioner chat in the terminal (counterpart of
`faithdiff_tpu/serving/chat.py`): load the captioner, attach one PNG or
JPEG, then
a multi-turn chat over it with a conversation template (vicuna_v1 by
default).

    python -m faithdiff_tpu_torch.serving.chat --captioner_dir C --image IMG \\
        [--temperature 0.2] [--max_new_tokens 512] [--template vicuna_v1] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("chat")
    p.add_argument("--captioner_dir", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--template", default="vicuna_v1")
    p.add_argument("--device", default="cuda",
                   help="torch device the captioner runs on")
    args = p.parse_args(argv)

    from ..captioner.agent import CaptionAgent
    from ..captioner.conversation import TEMPLATES
    from ..utils.png import read_rgb

    image = read_rgb(args.image)
    agent = CaptionAgent.from_checkpoint(args.captioner_dir, device=args.device)
    agent.temperature = args.temperature
    agent.max_new_tokens = args.max_new_tokens

    conv = TEMPLATES[args.template].copy()
    print(f"loaded {args.captioner_dir}; image {args.image}. "
          "Type a question (ctrl-d to exit).")
    first = True
    while True:
        try:
            question = input(f"{conv.roles[0]}: ").strip()
        except EOFError:
            print()
            return
        if not question:
            continue
        # single-image chat: the running conversation's text rides along
        # as the question's context
        history = "".join(
            f"{r}: {m} " for r, m in conv.messages if m)
        full_question = (history + question) if not first else question
        answer = agent.caption(image, question=full_question)
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], answer)
        first = False
        print(f"{conv.roles[1]}: {answer}")


if __name__ == "__main__":
    sys.exit(main() or 0)
