"""Full EvalAI VQA answer-normalization protocol (the port's copy of
`faithdiff_tpu/eval/vqa_protocol.py`).

Pure-Python protocol code: the exact normalization and scoring rules the
reference evaluation harness applies before comparing VQA answers
(`llava/eval/m4c_evaluator.py:9-216`, itself copied from
facebookresearch/mmf's EvalAI processor). These maps and regexes are
PROTOCOL CONSTANTS — accuracies only match the published benchmark
protocol if they are reproduced byte-for-byte, including the upstream
quirks (documented inline), so they are transcribed verbatim (class-b).

Exposes:
- ``process_answer(text)`` — the EvalAIAnswerProcessor pipeline
  (word_tokenize -> whitespace fold -> punctuation -> digit/article).
- ``textvqa_soft_scores(raw_answers)`` — the leave-one-out soft-voting
  table over 10 human answers (TextVQAAccuracyEvaluator).
- ``textvqa_eval(pred_list)`` / ``stvqa_eval(pred_list)`` /
  ``stvqa_anls_eval(pred_list)`` — the three pred-list evaluators
  (`m4c_evaluator.py:222-291`), the ANLS one on a pure-python edit
  distance (the reference imports the optional ``editdistance`` wheel).
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence

# --- protocol constants (m4c_evaluator.py:14-177, verbatim) -----------------

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")

# upstream quirk preserved: `(?!<=\d)` is a typo'd negative LOOKAHEAD for
# the literal text "<=d" (the author meant the lookbehind `(?<!\d)`), so in
# practice a period is stripped unless followed by a digit
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")

PUNCTUATIONS = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
]


# --- the processing pipeline (m4c_evaluator.py:180-216) ---------------------

def _word_tokenize(word: str) -> str:
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def _process_punctuation(in_text: str) -> str:
    out_text = in_text
    for p in PUNCTUATIONS:
        if (p + " " in in_text or " " + p in in_text) or (
                re.search(COMMA_STRIP, in_text) is not None):
            out_text = out_text.replace(p, "")
        else:
            out_text = out_text.replace(p, " ")
    # upstream quirk preserved: re.UNICODE (=32) is passed as sub()'s COUNT
    # argument, so only the first 32 periods are stripped
    out_text = PERIOD_STRIP.sub("", out_text, re.UNICODE)
    return out_text


def _process_digit_article(in_text: str) -> str:
    out_text = []
    for word in in_text.lower().split():
        word = NUMBER_MAP.get(word, word)
        if word not in ARTICLES:
            out_text.append(word)
    for i, word in enumerate(out_text):
        if word in CONTRACTIONS:
            out_text[i] = CONTRACTIONS[word]
    return " ".join(out_text)


def process_answer(item: str) -> str:
    """EvalAIAnswerProcessor.__call__ (m4c_evaluator.py:211-216)."""
    item = _word_tokenize(item)
    item = item.replace("\n", " ").replace("\t", " ").strip()
    item = _process_punctuation(item)
    item = _process_digit_article(item)
    return item


# --- pred-list evaluators (m4c_evaluator.py:222-291) ------------------------

def textvqa_soft_scores(raw_answers: Sequence[str]) -> Dict[str, float]:
    """Leave-one-out soft score per unique normalized answer over the 10
    human answers (TextVQAAccuracyEvaluator._compute_answer_scores)."""
    answers = [process_answer(a) for a in raw_answers]
    assert len(answers) == 10, "TextVQA protocol expects 10 human answers"
    gt_answers = list(enumerate(answers))
    scores: Dict[str, float] = {}
    for unique_answer in set(answers):
        accs = []
        for gt_answer in gt_answers:
            others = [it for it in gt_answers if it != gt_answer]
            matching = [it for it in others if it[1] == unique_answer]
            accs.append(min(1.0, float(len(matching)) / 3))
        scores[unique_answer] = sum(accs) / len(accs)
    return scores


def textvqa_eval(pred_list: List[dict]) -> float:
    """entries: {"pred_answer": str, "gt_answers": [10 strings]}."""
    pred_scores = []
    for entry in pred_list:
        pred = process_answer(entry["pred_answer"])
        pred_scores.append(
            textvqa_soft_scores(entry["gt_answers"]).get(pred, 0.0))
    return sum(pred_scores) / len(pred_scores)


def stvqa_eval(pred_list: List[dict]) -> float:
    """Exact-match after normalization (STVQAAccuracyEvaluator)."""
    pred_scores = []
    for entry in pred_list:
        pred = process_answer(entry["pred_answer"])
        gts = [process_answer(a) for a in entry["gt_answers"]]
        pred_scores.append(1.0 if pred in gts else 0.0)
    return sum(pred_scores) / len(pred_scores)


def _edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, pure python (the reference imports the
    optional ``editdistance`` wheel, absent here)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(s1: str, s2: str) -> float:
    """STVQAANLSEvaluator.get_anls: 1 - normalized edit distance,
    thresholded at 0.5."""
    s1, s2 = s1.lower().strip(), s2.lower().strip()
    iou = 1 - _edit_distance(s1, s2) / max(len(s1), len(s2))
    return iou if iou >= 0.5 else 0.0


def stvqa_anls_eval(pred_list: List[dict]) -> float:
    pred_scores = []
    for entry in pred_list:
        pred_scores.append(
            max(anls(entry["pred_answer"], gt)
                for gt in entry["gt_answers"]))
    return sum(pred_scores) / len(pred_scores)
