"""Reviewer-based pairwise answer scoring (the "GPT review" harness; the
port's copy of `faithdiff_tpu/eval/gpt_review.py`, with its own
`review_rules.json`).

Capability-equivalent to the reference's
`llava/eval/eval_gpt_review.py`,
`eval_gpt_review_visual.py` (context-conditioned variant),
`eval_gpt_review_bench.py` (llava-bench variant: `review-bench`),
`qa_baseline_gpt35.py` (text-only baseline generation: `qa-baseline`), and
`summarize_gpt_review.py` — with the OpenAI/ray coupling replaced by a
pluggable reviewer backend so the offline plumbing (prompt assembly, score
parser, resume-aware runner, summarizer) is testable without network access.

Record formats match the reference jsonl conventions:
- questions: {"question_id", "text", "category", ["image"]}
- answers:   {"question_id", "answer_id", "text"}
- context:   {"image", "captions": [...], "instances": [{"category","bbox"}]}
- reviews:   {"id", "question_id", "answer1_id", "answer2_id", "category",
              "content", "tuple": [score1, score2]}

A backend is any callable `(content: str, system: str, max_tokens: int) -> str`.
Select one on the CLI with `--backend module:function`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence

REVIEWER_SYSTEM = ("You are a helpful and precise assistant for checking "
                   "the quality of the answer.")

# the full reviewer rule set — protocol constants (rubric prompt text)
# mirroring the reference's `llava/eval/table/rule.json`, shipped as
# `review_rules.json` next to this module; pass --rule to override
def _load_default_rules() -> Dict[str, Dict]:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "review_rules.json")
    with open(path) as f:
        return json.load(f)


DEFAULT_RULES = _load_default_rules()


def parse_score(review: str) -> List[float]:
    """First line -> [score1, score2]; [-1, -1] on malformed reviews
    (reference `parse_score`, `eval_gpt_review.py:38-51`)."""
    try:
        pair = review.split("\n")[0].replace(",", " ").split()
        if len(pair) == 2:
            return [float(pair[0]), float(pair[1])]
    except (ValueError, IndexError):
        pass
    return [-1.0, -1.0]


def build_review_content(
    question: str,
    answer1: str,
    answer2: str,
    rule: Dict[str, str],
    context: Optional[str] = None,
) -> str:
    """The reviewer prompt (reference `eval_gpt_review.py:92-96`; the
    `[Context]` block is the visual variant, `eval_gpt_review_visual.py`)."""
    role = rule.get("role", "Assistant")
    prompt = rule["prompt"]
    parts = []
    if context:
        parts.append(f"[Context]\n{context}\n\n")
    parts.append(f"[Question]\n{question}\n\n")
    parts.append(f"[{role} 1]\n{answer1}\n\n[End of {role} 1]\n\n")
    parts.append(f"[{role} 2]\n{answer2}\n\n[End of {role} 2]\n\n")
    parts.append(f"[System]\n{prompt}\n\n")
    return "".join(parts)


def format_context(inst: Dict) -> str:
    """Caption + detection context string (`eval_gpt_review_visual.py:86-88`)."""
    cap_str = "\n".join(inst.get("captions", []))
    box_str = "\n".join(
        f'{b["category"]}: {b["bbox"]}' for b in inst.get("instances", []))
    return f"{cap_str}\n\n{box_str}"


def format_bench_context(inst: Dict) -> str:
    """llava-bench context: the `caption` field, a string or a list of
    strings (`eval_gpt_review_bench.py:87-91`)."""
    cap = inst["caption"]
    return "\n".join(cap) if isinstance(cap, list) else cap


def load_backend(spec: str) -> Callable[[str, str, int], str]:
    """Resolve `module:function` into a reviewer callable."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"backend spec must be module:function, got {spec!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), fn_name)


def review_answers(
    questions: Iterable[Dict],
    answers1: Iterable[Dict],
    answers2: Iterable[Dict],
    backend: Callable[[str, str, int], str],
    rules: Optional[Dict[str, Dict]] = None,
    contexts: Optional[Dict[str, Dict]] = None,
    max_tokens: int = 1024,
    done_ids: Optional[set] = None,
    bench_mode: bool = False,
    skip_first: int = 0,
) -> Iterable[Dict]:
    """Yield review records; skips question_ids in `done_ids` (the resume
    behaviour of `eval_gpt_review_visual.py:66-71`).

    `bench_mode` switches to the llava-bench conventions
    (`eval_gpt_review_bench.py:84-116`): category prefixed
    `llava_bench_` with a HARD error when absent from the rules, context
    from the `caption` field, `answer1_id` falling back to the answer's
    question_id, and POSITIONAL resume (`skip_first` records already
    reviewed, the reference's `idx >= len(cur_reviews)` check)."""
    rules = rules or DEFAULT_RULES
    done_ids = done_ids or set()
    idx = 0
    for ques, ans1, ans2 in zip(questions, answers1, answers2):
        idx += 1
        if bench_mode:
            if idx <= skip_first:
                continue
        elif ques["question_id"] in done_ids:
            continue
        category = ques.get("category", "default")
        if bench_mode:
            category = "llava_bench_" + category
            if category not in rules:
                raise KeyError(
                    f"Visual QA category not found in rule file: {category}.")
            rule = rules[category]
        else:
            rule = rules.get(category, rules.get("default"))
            if rule is None:
                raise KeyError(f"no rule for category {category!r}")
        context = None
        if contexts is not None:
            inst = contexts[ques["image"]]
            context = (format_bench_context(inst) if bench_mode
                       else format_context(inst))
        content = build_review_content(
            ques["text"], ans1["text"], ans2["text"], rule, context)
        review = backend(content, REVIEWER_SYSTEM, max_tokens)
        yield {
            "id": idx,
            "question_id": ques["question_id"],
            "answer1_id": ans1.get(
                "answer_id", ans1.get("question_id", "") if bench_mode
                else ""),
            "answer2_id": ans2.get("answer_id", ""),
            "category": category,
            "content": review,
            "tuple": parse_score(review),
        }


def summarize_reviews(records: Iterable[Dict],
                      ignore: Sequence = ()) -> Dict[str, Dict[str, float]]:
    """Per-category means + relative score, the `summarize_gpt_review.py`
    math: relative = mean2/mean1*100, scores scaled x10."""
    scores = defaultdict(list)
    for rec in records:
        if rec.get("question_id") in set(ignore):
            continue
        pair = rec.get("tuple", rec.get("score"))
        if pair is None:
            continue
        scores[rec.get("category", "all")].append(pair)
        if "category" in rec:
            scores["all"].append(pair)
    out = {}
    for cat, pairs in sorted(scores.items()):
        n = len(pairs)
        m1 = sum(p[0] for p in pairs) / n
        m2 = sum(p[1] for p in pairs) / n
        out[cat] = {
            "count": n,
            "score1": round(m1 * 10, 1),
            "score2": round(m2 * 10, 1),
            "relative": round(m2 / m1 * 100, 1) if m1 else float("nan"),
        }
    return out


def _read_jsonl(path: str) -> List[Dict]:
    with open(os.path.expanduser(path)) as f:
        return [json.loads(line) for line in f if line.strip()]


def unavailable_backend(content: str, system: str, max_tokens: int) -> str:
    raise RuntimeError(
        "no reviewer backend configured: pass --backend module:function "
        "(a callable (content, system, max_tokens) -> str, e.g. a wrapper "
        "over an LLM API client)")


def cmd_review(argv):
    p = argparse.ArgumentParser("gpt_review review")
    p.add_argument("-q", "--question", required=True)
    p.add_argument("-a", "--answer-list", nargs=2, required=True)
    p.add_argument("-c", "--context", default=None)
    p.add_argument("-r", "--rule", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--backend", default=None,
                   help="module:function reviewer backend")
    p.add_argument("--max-tokens", type=int, default=1024)
    args = p.parse_args(argv)

    rules = (json.load(open(os.path.expanduser(args.rule)))
             if args.rule else DEFAULT_RULES)
    contexts = None
    if args.context:
        contexts = {c["image"]: c for c in _read_jsonl(args.context)}
    backend = (load_backend(args.backend) if args.backend
               else unavailable_backend)
    done = set()
    if os.path.isfile(args.output):
        done = {r["question_id"] for r in _read_jsonl(args.output)}
    with open(args.output, "a") as out:
        for rec in review_answers(
                _read_jsonl(args.question),
                _read_jsonl(args.answer_list[0]),
                _read_jsonl(args.answer_list[1]),
                backend, rules, contexts, args.max_tokens, done):
            out.write(json.dumps(rec) + "\n")
            out.flush()
    print(f"reviews written to {args.output}")


def cmd_review_bench(argv):
    """llava-bench-in-the-wild review (`eval_gpt_review_bench.py`):
    positional resume, `caption`-field context, llava_bench_* rules."""
    p = argparse.ArgumentParser("gpt_review review-bench")
    p.add_argument("-q", "--question", required=True)
    p.add_argument("-c", "--context", required=True)
    p.add_argument("-a", "--answer-list", nargs=2, required=True)
    p.add_argument("-r", "--rule", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--backend", default=None,
                   help="module:function reviewer backend")
    p.add_argument("--max-tokens", type=int, default=1024)
    args = p.parse_args(argv)

    rules = (json.load(open(os.path.expanduser(args.rule)))
             if args.rule else DEFAULT_RULES)
    contexts = {c["image"]: c for c in _read_jsonl(args.context)}
    backend = (load_backend(args.backend) if args.backend
               else unavailable_backend)
    skip = len(_read_jsonl(args.output)) if os.path.isfile(args.output) else 0
    with open(args.output, "a") as out:
        for rec in review_answers(
                _read_jsonl(args.question),
                _read_jsonl(args.answer_list[0]),
                _read_jsonl(args.answer_list[1]),
                backend, rules, contexts, args.max_tokens,
                bench_mode=True, skip_first=skip):
            out.write(json.dumps(rec) + "\n")
            out.flush()
    print(f"reviews written to {args.output}")


def generate_qa_baseline(
    questions: Dict,
    backend: Callable[[str, str, int], str],
    max_tokens: int = 1024,
    max_workers: int = 32,
    model_id: str = "text-baseline",
) -> List[Dict]:
    """Text-only baseline answer generation
    (`llava/eval/qa_baseline_gpt35.py:17-76`): answer every
    question through the reviewer-style backend concurrently, '#ERROR#' on
    repeated failure, results sorted by question_id."""
    import concurrent.futures

    def get_answer(qid, question):
        ans = {"answer_id": f"baseline-{qid}", "question_id": qid,
               "model_id": model_id}
        for _ in range(3):
            try:
                ans["text"] = backend(
                    question, "You are a helpful assistant.", max_tokens)
                return ans
            except Exception as e:
                print("[ERROR]", e)
                ans["text"] = "#ERROR#"
        return ans

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers) as ex:
        futures = [ex.submit(get_answer, qid, q)
                   for qid, q in questions.items()]
        answers = [f.result()
                   for f in concurrent.futures.as_completed(futures)]
    answers.sort(key=lambda x: x["question_id"])
    return answers


def cmd_qa_baseline(argv):
    p = argparse.ArgumentParser("gpt_review qa-baseline")
    p.add_argument("-q", "--question", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--backend", default=None)
    p.add_argument("--max-tokens", type=int, default=1024)
    args = p.parse_args(argv)

    questions = {q["question_id"]: q["text"]
                 for q in _read_jsonl(args.question)}
    backend = (load_backend(args.backend) if args.backend
               else unavailable_backend)
    answers = generate_qa_baseline(questions, backend, args.max_tokens)
    with open(os.path.expanduser(args.output), "w") as f:
        f.write("\n".join(json.dumps(a) for a in answers))
    print(f"answers written to {args.output}")


def cmd_summarize(argv):
    p = argparse.ArgumentParser("gpt_review summarize")
    p.add_argument("-f", "--files", nargs="+", required=True)
    p.add_argument("-i", "--ignore", nargs="*", default=[])
    args = p.parse_args(argv)
    for path in args.files:
        print(os.path.basename(path))
        table = summarize_reviews(_read_jsonl(path), ignore=args.ignore)
        for cat, row in table.items():
            print(f"  {cat}: relative={row['relative']} "
                  f"score1={row['score1']} score2={row['score2']} "
                  f"n={row['count']}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmds = {"review": cmd_review, "review-bench": cmd_review_bench,
            "qa-baseline": cmd_qa_baseline, "summarize": cmd_summarize}
    if not argv or argv[0] not in cmds:
        print("usage: python -m faithdiff_tpu_torch.eval.gpt_review "
              "{review|review-bench|qa-baseline|summarize} ...")
        return 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
