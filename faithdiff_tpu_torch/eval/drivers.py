"""Per-benchmark eval CLI drivers (the port's copy of
`faithdiff_tpu/eval/drivers.py`).

Thin drivers mirroring the reference's standalone evaluator scripts:

- ``textvqa``: `llava/eval/eval_textvqa.py` — match answer
  records to TextVQA annotations by (question_id, lowercased question
  extracted from the prompt), score with the full EvalAI protocol
  (`vqa_protocol.textvqa_eval`). Accepts one result file or a directory.
- ``pope``: `llava/eval/eval_pope.py` — per-category
  (adversarial/popular/random `coco_pope_*.json` label files) yes/no
  metrics via the reference-exact binarisation (`scorers.pope_metrics`).

Both operate on jsonl answer files written by the generators in
`vqa.py`/`generators.py` (same record conventions as the reference's
`model_vqa*.py`).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List


def _read_jsonl(path: str) -> List[Dict]:
    with open(os.path.expanduser(path)) as f:
        return [json.loads(line) for line in f if line.strip()]


def textvqa_prompt_processor(prompt: str) -> str:
    """Extract the bare question from a TextVQA prompt
    (reference `eval_textvqa.py:17-32`: OCR-token prefixed, reference-OCR
    3-line, or plain question+instruction 2-line forms)."""
    if prompt.startswith("OCR tokens: "):
        match = re.search(r"Question: (.*?) Short answer:", prompt,
                          re.DOTALL)
        question = match.group(1)
    elif "Reference OCR token: " in prompt and len(prompt.split("\n")) == 3:
        if prompt.startswith("Reference OCR token:"):
            question = prompt.split("\n")[1]
        else:
            question = prompt.split("\n")[0]
    elif len(prompt.split("\n")) == 2:
        question = prompt.split("\n")[0]
    else:
        raise ValueError(f"unrecognised TextVQA prompt format: {prompt!r}")
    return question.lower()


def eval_textvqa_single(annotation_file: str, result_file: str) -> Dict:
    """Score one answers jsonl against the TextVQA annotation json
    (`eval_textvqa.py:35-51`)."""
    from .vqa_protocol import textvqa_eval

    annotations = json.load(open(os.path.expanduser(annotation_file)))["data"]
    annotations = {(a["image_id"], a["question"].lower()): a
                   for a in annotations}
    results = _read_jsonl(result_file)
    pred_list = []
    for result in results:
        ann = annotations[(result["question_id"],
                           textvqa_prompt_processor(result["prompt"]))]
        pred_list.append({"pred_answer": result["text"],
                          "gt_answers": ann["answers"]})
    return {"samples": len(pred_list),
            "accuracy": 100.0 * textvqa_eval(pred_list)}


def cmd_textvqa(argv) -> int:
    p = argparse.ArgumentParser("eval textvqa")
    p.add_argument("--annotation-file", required=True)
    p.add_argument("--result-file", default=None)
    p.add_argument("--result-dir", default=None)
    args = p.parse_args(argv)

    targets = []
    if args.result_file:
        targets.append(args.result_file)
    if args.result_dir:
        for name in sorted(os.listdir(args.result_dir)):
            if name.endswith(".jsonl"):
                targets.append(os.path.join(args.result_dir, name))
            else:
                print(f"Skipping {name}")
    for path in targets:
        out = eval_textvqa_single(args.annotation_file, path)
        print(os.path.splitext(os.path.basename(path))[0])
        print("Samples: {}\nAccuracy: {:.2f}%\n".format(
            out["samples"], out["accuracy"]))
    return 0


def eval_pope_category(answers: List[Dict], label_file: str) -> Dict:
    """One POPE category: reference accounting (`eval_pope.py:5-62`)."""
    from .scorers import pope_metrics

    labels = [json.loads(q)["label"] for q in open(label_file)]
    m = pope_metrics([a["text"] for a in answers], labels)
    m["samples"] = len(answers)
    return m


def cmd_pope(argv) -> int:
    p = argparse.ArgumentParser("eval pope")
    p.add_argument("--annotation-dir", required=True)
    p.add_argument("--question-file", required=True)
    p.add_argument("--result-file", required=True)
    args = p.parse_args(argv)

    questions = {q["question_id"]: q
                 for q in _read_jsonl(args.question_file)}
    answers = _read_jsonl(args.result_file)
    for name in sorted(os.listdir(args.annotation_dir)):
        if not (name.startswith("coco_pope_") and name.endswith(".json")):
            continue
        category = name[10:-5]
        cur = [a for a in answers
               if questions[a["question_id"]]["category"] == category]
        print(f"Category: {category}, # samples: {len(cur)}")
        m = eval_pope_category(cur, os.path.join(args.annotation_dir, name))
        print("Accuracy: {}".format(m["accuracy"]))
        print("Precision: {}".format(m["precision"]))
        print("Recall: {}".format(m["recall"]))
        print("F1 score: {}".format(m["f1"]))
        print("Yes ratio: {}".format(m["yes_ratio"]))
        print("%.3f, %.3f, %.3f, %.3f, %.3f" % (
            m["f1"], m["accuracy"], m["precision"], m["recall"],
            m["yes_ratio"]))
        print("====================================")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmds = {"textvqa": cmd_textvqa, "pope": cmd_pope}
    if not argv or argv[0] not in cmds:
        print("usage: python -m faithdiff_tpu_torch.eval.drivers {textvqa|pope} ...")
        return 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
