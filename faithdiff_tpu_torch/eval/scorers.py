"""Benchmark answer scorers (the port's copy of
`faithdiff_tpu/eval/scorers.py`).

Equivalents of the reference's per-benchmark LLaVA evaluators
(`llava/eval/`): ScienceQA option parsing
(`eval_science_qa.py`), POPE yes/no metrics (`eval_pope.py`), TextVQA
soft-voting accuracy (`m4c_evaluator.py:334` VQA-style), MMBench option
matching. Pure string/statistics functions, no datasets required.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from . import vqa_protocol


def parse_multiple_choice(answer: str, options: Sequence[str] = "ABCDE"
                          ) -> Optional[str]:
    """Extract the chosen option letter from a model answer
    (ScienceQA/MMBench convention: 'The answer is A.' / 'A.' / 'A')."""
    patterns = [
        r"[Tt]he answer is ([A-E])\b",
        r"^\(?([A-E])\)?[.,:\s]",
        r"^\(?([A-E])\)?$",
    ]
    answer = answer.strip()
    for pat in patterns:
        m = re.search(pat, answer)
        if m and m.group(1) in options:
            return m.group(1)
    return None


def science_qa_accuracy(answers: List[str], truths: List[str]) -> float:
    assert len(answers) == len(truths)
    correct = sum(
        1 for a, t in zip(answers, truths)
        if parse_multiple_choice(a) == t
    )
    return correct / max(len(answers), 1)


def pope_normalize_answer(text: str) -> str:
    """The reference's exact answer binarisation (`eval_pope.py:9-21`):
    keep the first sentence, drop commas, and answer 'no' iff one of the
    WORDS 'No'/'not'/'no' appears — anything else is 'yes' (so an
    undecidable answer counts as yes)."""
    if text.find(".") != -1:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) \
        else "yes"


def pope_metrics(answers: List[str], labels: List[str]) -> Dict[str, float]:
    """POPE object-hallucination metrics: binary yes/no with
    precision/recall/F1/accuracy and the yes-ratio (`eval_pope.py:23-62`),
    using the reference's exact answer binarisation."""
    tp = fp = tn = fn = 0
    yes = 0
    for a, l in zip(answers, labels):
        pred = pope_normalize_answer(a) == "yes"
        truth = l.strip().lower() == "yes"
        yes += pred
        if pred and truth:
            tp += 1
        elif pred and not truth:
            fp += 1
        elif not pred and truth:
            fn += 1
        else:
            tn += 1
    n = max(len(answers), 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": yes / n,
    }


def _vqa_normalize(ans: str) -> str:
    """VQA answer normalisation: the FULL EvalAI protocol pipeline
    (contractions, number map, articles, punctuation/comma/period rules —
    `m4c_evaluator.py:9-216`, transcribed in `vqa_protocol.py`)."""
    return vqa_protocol.process_answer(ans)


def vqa_accuracy(answer: str, gt_answers: Sequence[str]) -> float:
    """VQA-style soft accuracy: min(1, #matching_humans / 3)
    (`m4c_evaluator.py` EvalAIAnswerProcessor convention)."""
    norm = _vqa_normalize(answer)
    matches = sum(1 for g in gt_answers if _vqa_normalize(g) == norm)
    return min(1.0, matches / 3.0)


def textvqa_accuracy(answers: List[str],
                     gt_answer_lists: List[Sequence[str]]) -> float:
    """TextVQA accuracy. With the protocol's 10 human answers per question
    this is the reference's exact leave-one-out soft-voting evaluator
    (`m4c_evaluator.py:222-259`); other counts fall back to the plain
    min(1, matches/3) vote (the protocol formula is undefined there)."""
    assert len(answers) == len(gt_answer_lists)
    scores = []
    for a, g in zip(answers, gt_answer_lists):
        if len(g) == 10:
            scores.append(vqa_protocol.textvqa_soft_scores(g).get(
                _vqa_normalize(a), 0.0))
        else:
            scores.append(vqa_accuracy(a, g))
    return sum(scores) / max(len(scores), 1)


def mmbench_accuracy(answers: List[str], truths: List[str],
                     options_per_q: Optional[List[Dict[str, str]]] = None
                     ) -> float:
    """MMBench: option-letter match, falling back to matching the option
    TEXT when the model answered with the content instead of the letter."""
    correct = 0
    for i, (a, t) in enumerate(zip(answers, truths)):
        choice = parse_multiple_choice(a)
        if choice is None and options_per_q:
            norm = _vqa_normalize(a)
            for letter, text in options_per_q[i].items():
                if _vqa_normalize(text) == norm:
                    choice = letter
                    break
        correct += choice == t
    return correct / max(len(answers), 1)
