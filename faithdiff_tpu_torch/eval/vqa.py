"""VQA-style eval harness for the captioner (counterpart of
`faithdiff_tpu/eval/vqa.py`), on the port's `CaptionAgent`. Images are
PNGs (`utils/png.read_rgb`; a JPEG raises naming ROADMAP §1.1).

Capability-equivalent to the reference's LLaVA eval answer generators
(`llava/eval/model_vqa.py:101` et al.): iterate a questions
file (JSONL with {question_id, image, text}), run the caption agent with
each question as the prompt, write answers JSONL with chunked sharding
(`--num-chunks/--chunk-idx` in the reference).

GPT-review scoring lives in `gpt_review.py` (pluggable backend); the
per-benchmark drivers in `drivers.py`; benchmark-specific generators in
`generators.py`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Optional

import numpy as np

from ..utils.png import read_rgb


def get_chunk(lst: List, n: int, k: int) -> List:
    """Split lst into n chunks, return chunk k (reference `split_list`)."""
    size = math.ceil(len(lst) / n)
    return lst[k * size:(k + 1) * size]


def run_vqa(
    agent,
    question_file: str,
    image_dir: str,
    answers_file: str,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    max_questions: Optional[int] = None,
) -> int:
    """Generate answers for a chunk of questions. Returns count written."""
    with open(question_file) as f:
        questions = [json.loads(line) for line in f if line.strip()]
    questions = get_chunk(questions, num_chunks, chunk_idx)
    if max_questions:
        questions = questions[:max_questions]

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    n = 0
    with open(answers_file, "w") as out:
        for q in questions:
            img_path = os.path.join(image_dir, q["image"])
            img = read_rgb(img_path)
            answer = agent.caption(img, question=q["text"])
            out.write(json.dumps({
                "question_id": q.get("question_id", n),
                "prompt": q["text"],
                "text": answer,
                "model_id": "faithdiff-tpu-captioner",
            }) + "\n")
            n += 1
    return n


def summarize_answers(answers_file: str) -> dict:
    with open(answers_file) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    lengths = [len(r["text"].split()) for r in rows]
    return {
        "num_answers": len(rows),
        "mean_words": float(np.mean(lengths)) if lengths else 0.0,
        "empty": sum(1 for r in rows if not r["text"].strip()),
    }


def main(argv=None):
    p = argparse.ArgumentParser("vqa")
    p.add_argument("--question-file", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--answers-file", required=True)
    p.add_argument("--captioner-dir", required=True)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device the captioner runs on")
    args = p.parse_args(argv)

    from ..captioner.agent import CaptionAgent

    agent = CaptionAgent.from_checkpoint(args.captioner_dir, device=args.device)
    n = run_vqa(agent, args.question_file, args.image_dir, args.answers_file,
                args.num_chunks, args.chunk_idx)
    print(json.dumps({"written": n,
                      **summarize_answers(args.answers_file)}))
