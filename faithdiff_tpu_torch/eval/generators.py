"""Benchmark-specific answer generators + combiners (counterpart of
`faithdiff_tpu/eval/generators.py`).

Capability-equivalents of the reference's benchmark-specific LLaVA eval
scripts:

- MMBench TSV generator with circular option rotation
  (`llava/eval/model_vqa_mmbench.py:54-140`) plus the
  circular-consistency scorer the MMBench protocol applies server-side.
- Prefetching ("loader") VQA generator
  (`llava/eval/model_vqa_loader.py:31-126`): image
  decoding runs in a background thread while the device generates on the
  calling thread, the answer to the reference's `DataLoader(num_workers=4)`.
- ScienceQA GPT-4 requery combiner
  (`llava/eval/eval_science_qa_gpt4_requery.py:40-148`):
  merges our visual answers, GPT-4 text answers, and requery answers into
  the reference's accuracy accounting.

All functions take a caption `agent` duck-typed as
`agent.caption(image: np.ndarray, question: str) -> str` so they are
testable with a stub agent. Images are PNGs (`utils/png`); a JPEG file
or MMBench row raises naming ROADMAP §1.1.
"""
from __future__ import annotations

import argparse
import base64
import csv
import json
import math
import os
import queue
import re
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..utils.png import decode_png, read_rgb

ALL_OPTIONS = ["A", "B", "C", "D"]


def get_chunk(lst: List, n: int, k: int) -> List:
    size = math.ceil(len(lst) / n)
    return lst[k * size:(k + 1) * size]


def _is_none(value) -> bool:
    """Reference `is_none` (`model_vqa_mmbench.py:33-42`): NaN floats and
    'nan'/'none' strings in the TSV count as absent options."""
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("", "nan", "none"):
        return True
    return False


def get_options(row: Dict, options: Sequence[str] = ALL_OPTIONS) -> List[str]:
    parsed = []
    for option in options:
        v = row.get(option)
        if _is_none(v):
            break
        parsed.append(v)
    return parsed


def read_mmbench_tsv(path: str) -> List[Dict]:
    """MMBench distributes as a TSV with columns
    index/question/hint/A..D/image (base64) [+ answer on the dev split]."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def _decode_b64_image(data: str) -> np.ndarray:
    return decode_png(base64.b64decode(data), "MMBench image")


def build_mmbench_question(row: Dict, options: List[str],
                           single_pred_prompt: bool = True,
                           lang: str = "en") -> str:
    """Prompt assembly (`model_vqa_mmbench.py:81-99`): hint + question +
    lettered options (+ the single-letter instruction)."""
    question = row["question"]
    if not _is_none(row.get("hint")):
        question = row["hint"] + "\n" + question
    for letter, option in zip(ALL_OPTIONS, options):
        question = question + "\n" + letter + ". " + option
    if single_pred_prompt:
        if lang == "cn":
            question += "\n" + "请直接回答选项字母。"
        else:
            question += ("\nAnswer with the option's letter from the given "
                         "choices directly.")
    return question


def run_mmbench(
    agent,
    question_file: str,
    answers_file: str,
    all_rounds: bool = True,
    single_pred_prompt: bool = True,
    lang: str = "en",
    num_chunks: int = 1,
    chunk_idx: int = 0,
    max_questions: Optional[int] = None,
) -> int:
    """Generate MMBench answers with circular option rotation.

    Round r presents the options rotated left by r; `option_char[i]`
    records the ORIGINAL letter of the option displayed at position
    `ALL_OPTIONS[i]`, exactly the reference's rotating `cur_option_char`
    (`model_vqa_mmbench.py:73-139`) — it is what lets the scorer map a
    displayed-letter answer back to the canonical option."""
    rows = get_chunk(read_mmbench_tsv(question_file), num_chunks, chunk_idx)
    if max_questions:
        rows = rows[:max_questions]
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    n = 0
    with open(answers_file, "w") as out:
        for row in rows:
            options = get_options(row)
            option_char = ALL_OPTIONS[:len(options)]
            image = _decode_b64_image(row["image"])
            rounds = len(options) if all_rounds else 1
            for round_idx in range(rounds):
                prompt = build_mmbench_question(
                    row, options, single_pred_prompt, lang)
                text = agent.caption(image, question=prompt)
                out.write(json.dumps({
                    "question_id": row["index"],
                    "round_id": round_idx,
                    "prompt": prompt,
                    "text": text,
                    "options": options,
                    "option_char": option_char,
                    "model_id": "faithdiff-tpu-captioner",
                }) + "\n")
                n += 1
                options = options[1:] + options[:1]
                option_char = option_char[1:] + option_char[:1]
    return n


def derotate_answer(displayed_letter: Optional[str],
                    option_char: Sequence[str]) -> Optional[str]:
    """Map a displayed-position letter back to the canonical option letter
    for a rotated round (inverse of the generator's rotation)."""
    if displayed_letter is None:
        return None
    try:
        return option_char[ALL_OPTIONS.index(displayed_letter)]
    except (ValueError, IndexError):
        return None


def mmbench_circular_accuracy(answers: Iterable[Dict],
                              truths: Dict[str, str]) -> Dict[str, float]:
    """Circular evaluation: a question is correct only when EVERY rotated
    round derotates to the ground-truth letter (the MMBench protocol's
    CircularEval; the reference generates the rounds and defers scoring to
    the benchmark server). Also reports plain round-0 accuracy."""
    from .scorers import parse_multiple_choice

    by_q: Dict[str, List[Dict]] = defaultdict(list)
    for rec in answers:
        by_q[str(rec["question_id"])].append(rec)

    circular_correct = 0
    plain_correct = 0
    total = 0
    for qid, recs in by_q.items():
        truth = truths.get(qid)
        if truth is None:
            continue
        total += 1
        ok = True
        for rec in sorted(recs, key=lambda r: r.get("round_id", 0)):
            displayed = parse_multiple_choice(rec["text"])
            canonical = derotate_answer(displayed, rec["option_char"])
            if rec.get("round_id", 0) == 0 and canonical == truth:
                plain_correct += 1
            if canonical != truth:
                ok = False
        circular_correct += ok
    return {
        "circular_accuracy": circular_correct / max(total, 1),
        "accuracy": plain_correct / max(total, 1),
        "count": total,
    }


def run_vqa_loader(
    agent,
    question_file: str,
    image_dir: str,
    answers_file: str,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    prefetch: int = 2,
    max_questions: Optional[int] = None,
) -> int:
    """Prefetching VQA generator: a background thread loads + decodes the
    next images while the device generates the current answer — the
    reference's `DataLoader(num_workers=4)` overlap
    (`model_vqa_loader.py:72-98`) without a DataLoader. The thread only
    reads files; the device work stays on the calling thread."""
    with open(question_file) as f:
        questions = [json.loads(line) for line in f if line.strip()]
    questions = get_chunk(questions, num_chunks, chunk_idx)
    if max_questions:
        questions = questions[:max_questions]
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    _SENTINEL = object()

    def producer():
        for line in questions:
            path = os.path.join(image_dir, line["image"])
            try:
                img = read_rgb(path)
                q.put((line, img, None))
            except Exception as e:  # surface decode errors on the consumer
                q.put((line, None, e))
        q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    n = 0
    with open(answers_file, "w") as out:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            line, img, err = item
            if err is not None:
                raise err
            text = agent.caption(img, question=line["text"])
            out.write(json.dumps({
                "question_id": line.get("question_id", n),
                "prompt": line["text"],
                "text": text,
                "model_id": "faithdiff-tpu-captioner",
            }) + "\n")
            n += 1
    t.join()
    return n


SQA_SINGLE_PRED_SUFFIX = ("Answer with the option's letter from the given "
                          "choices directly.")


def run_science_qa(
    agent,
    question_file: str,
    image_dir: str,
    answers_file: str,
    single_pred_prompt: bool = True,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    max_questions: Optional[int] = None,
) -> int:
    """ScienceQA answer generator
    (`llava/eval/model_vqa_science.py:29-95`): questions are
    a JSON LIST of {"id", "conversations", ["image"]}; the prompt is the
    first conversation turn with the '<image>' placeholder stripped, plus
    the single-letter instruction. Text-only questions run without an
    image (the reference passes images=None)."""
    questions = json.load(open(os.path.expanduser(question_file)))
    questions = get_chunk(questions, num_chunks, chunk_idx)
    if max_questions:
        questions = questions[:max_questions]
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    n = 0
    with open(answers_file, "w") as out:
        for line in questions:
            qs = line["conversations"][0]["value"].replace(
                "<image>", "").strip()
            cur_prompt = qs
            img = None
            if "image" in line:
                img = read_rgb(os.path.join(image_dir, line["image"]))
                cur_prompt = "<image>" + "\n" + cur_prompt
            if single_pred_prompt:
                qs = qs + "\n" + SQA_SINGLE_PRED_SUFFIX
                cur_prompt = cur_prompt + "\n" + SQA_SINGLE_PRED_SUFFIX
            text = agent.caption(img, question=qs)
            out.write(json.dumps({
                "question_id": line["id"],
                "prompt": cur_prompt,
                "text": text,
                "model_id": "faithdiff-tpu-captioner",
                "metadata": {},
            }) + "\n")
            n += 1
    return n


# --- ScienceQA GPT-4 requery combining ------------------------------------

_ANSWER_PATTERN = re.compile(r"The answer is ([A-Z]).")


def parse_sqa_answer(text: str) -> str:
    """'The answer is X.' -> 'X', else 'FAILED'
    (`eval_science_qa_gpt4_requery.py:77-94`)."""
    found = _ANSWER_PATTERN.findall(text)
    return found[0] if len(found) == 1 else "FAILED"


def _pred_idx(letter: str, choices: Sequence, options: Sequence[str],
              fallback_rng) -> int:
    """Reference `get_pred_idx` (`:30-37`): a failed parse draws a random
    choice — seeded here so the accounting is reproducible."""
    if letter in options[:len(choices)]:
        return options.index(letter)
    return int(fallback_rng.integers(len(choices)))


def science_qa_requery_eval(
    problems: Dict[str, Dict],
    split_indices: Sequence[str],
    our_predictions: Dict[str, Dict],
    requery_predictions: Dict[str, Dict],
    gpt4_predictions: Dict[str, str],
    options: Sequence[str] = ("A", "B", "C", "D", "E"),
    seed: int = 0,
) -> Dict:
    """The requery combining flow (`eval_science_qa_gpt4_requery.py:55-148`):
    prefer the requery answer when it parses, fall back to our visual
    answer; track our/GPT-4/requery/upper-bound accuracies."""
    rng = np.random.default_rng(seed)
    results: Dict[str, int] = defaultdict(int)
    sqa_results = {"acc": None, "correct": None, "count": None,
                   "results": {}, "outputs": {}}

    for prob_id in split_indices:
        prob = problems[prob_id]
        our_pred = our_predictions[prob_id]["text"]
        gpt4_pred = gpt4_predictions[prob_id]
        if prob_id not in requery_predictions:
            results["missing_requery"] += 1
            requery_pred = "MISSING"
        else:
            requery_pred = requery_predictions[prob_id]["text"]

        our_answer = parse_sqa_answer(our_pred)
        requery_answer = parse_sqa_answer(requery_pred)
        gpt4_answer = parse_sqa_answer(gpt4_pred)

        our_idx = _pred_idx(our_answer, prob["choices"], options, rng)
        gpt4_idx = _pred_idx(gpt4_answer, prob["choices"], options, rng)
        requery_idx = _pred_idx(requery_answer, prob["choices"], options, rng)

        results["total"] += 1
        if gpt4_answer == "FAILED":
            results["gpt4_failed"] += 1
            results["gpt4_correct"] += gpt4_idx == prob["answer"]
            results["gpt4_ourvisual_correct"] += our_idx == prob["answer"]
        elif gpt4_idx == prob["answer"]:
            results["gpt4_correct"] += 1
            results["gpt4_ourvisual_correct"] += 1

        results["our_correct"] += our_idx == prob["answer"]

        if requery_answer == "FAILED":
            sqa_results["results"][prob_id] = our_idx
            results["requery_correct"] += our_idx == prob["answer"]
        else:
            sqa_results["results"][prob_id] = requery_idx
            results["requery_correct"] += requery_idx == prob["answer"]

        if gpt4_idx == prob["answer"] or our_idx == prob["answer"]:
            results["correct_upperbound"] += 1

    total = max(results["total"], 1)
    sqa_results["acc"] = results["requery_correct"] / total * 100
    sqa_results["correct"] = results["requery_correct"]
    sqa_results["count"] = results["total"]
    sqa_results["breakdown"] = dict(results)
    return sqa_results


def _read_jsonl(path: str) -> List[Dict]:
    with open(os.path.expanduser(path)) as f:
        return [json.loads(line) for line in f if line.strip()]


def cmd_sqa_requery(argv=None):
    """CLI mirroring `eval_science_qa_gpt4_requery.py` flags."""
    p = argparse.ArgumentParser("sqa-requery")
    p.add_argument("--base-dir", required=True)
    p.add_argument("--gpt4-result", required=True)
    p.add_argument("--requery-result", required=True)
    p.add_argument("--our-result", required=True)
    p.add_argument("--output-result", required=True)
    p.add_argument("--split", default="test")
    args = p.parse_args(argv)

    split_indices = json.load(
        open(os.path.join(args.base_dir, "pid_splits.json")))[args.split]
    problems = json.load(
        open(os.path.join(args.base_dir, "problems.json")))
    ours = {r["question_id"]: r for r in _read_jsonl(args.our_result)}
    requery = {r["question_id"]: r for r in _read_jsonl(args.requery_result)}
    gpt4 = json.load(open(args.gpt4_result))["outputs"]

    out = science_qa_requery_eval(problems, split_indices, ours, requery,
                                  gpt4)
    b = out["breakdown"]
    t = max(out["count"], 1)
    print(f"Total: {t}, Our-Correct: {b.get('our_correct', 0)}, "
          f"Accuracy: {b.get('our_correct', 0) / t * 100:.2f}%")
    print(f"Total: {t}, Requery-Correct: {out['correct']}, "
          f"Accuracy: {out['acc']:.2f}%")
    with open(args.output_result, "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    import sys

    sys.exit(cmd_sqa_requery(sys.argv[1:]) or 0)
