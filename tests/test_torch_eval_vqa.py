"""The port's VQA, benchmark-generator, TextVQA / POPE and review harnesses
(`faithdiff_tpu_torch/eval/{vqa,generators,drivers,gpt_review,scorers,
vqa_protocol}.py`) against the JAX package's on crafted inputs: answer
files byte for byte, scores and CLI output equal. The agent is a stub
whose answer depends on the image's pixels and the question (so a wrong
image or prompt shows), and, for `run_vqa`, the port's CaptionAgent at
the tiny LLaMA / CLIP configs, whose answers the JAX harness replays.
Images are PNGs and JPEGs: the port reads them itself (the JAX harness
through PIL), and refuses the JPEGs its decoder does not take naming
ROADMAP §1.1."""
import base64
import csv
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from faithdiff_tpu.eval import drivers as jdrivers
from faithdiff_tpu.eval import generators as jgen
from faithdiff_tpu.eval import gpt_review as jreview
from faithdiff_tpu.eval import scorers as jscorers
from faithdiff_tpu.eval import vqa as jvqa
from faithdiff_tpu.eval import vqa_protocol as jproto
from faithdiff_tpu_torch.captioner import agent as ta
from faithdiff_tpu_torch.captioner import clip_vision as tc
from faithdiff_tpu_torch.captioner import llama as tl
from faithdiff_tpu_torch.eval import drivers as tdrivers
from faithdiff_tpu_torch.eval import generators as tgen
from faithdiff_tpu_torch.eval import gpt_review as treview
from faithdiff_tpu_torch.eval import scorers as tscorers
from faithdiff_tpu_torch.eval import vqa as tvqa
from faithdiff_tpu_torch.eval import vqa_protocol as tproto
from faithdiff_tpu_torch.utils.png import write_png
from test_caption_agent import StubTokenizer

RNG = np.random.default_rng(0)


class PixelAgent:
    """Answers with a digest of the image and the question."""

    def caption(self, image, question):
        pix = "none" if image is None else f"{image.shape} {int(image.sum()) % 9973}"
        return f"The answer is {'ABCD'[len(question) % 4]}. {pix} {question[-12:]!r}"


def _png_bytes(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def vqa_files(tmp_path):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        write_png(str(imgs / f"im{i}.png"),
                  RNG.integers(0, 256, (20 + 4 * i, 24, 3), dtype=np.uint8))
    qfile = tmp_path / "q.jsonl"
    qs = [{"question_id": k, "image": f"im{k % 2}.png", "text": t,
           "category": "popular"}
          for k, t in enumerate(["Is there a cat?", "What colour?\nAnswer briefly.",
                                 "How many?", "Is it day?"])]
    qfile.write_text("".join(json.dumps(q) + "\n" for q in qs))
    return str(qfile), str(imgs)


def _same_file(a, b):
    assert open(a, "rb").read() == open(b, "rb").read()


def test_run_vqa_and_loader_write_jax_records(vqa_files, tmp_path):
    qfile, imgs = vqa_files
    for run in ("run_vqa", "run_vqa_loader"):
        mod_t, mod_j = (tvqa, jvqa) if run == "run_vqa" else (tgen, jgen)
        for chunks, idx in ((1, 0), (3, 1)):
            ours, want = tmp_path / f"t_{run}{idx}.jsonl", tmp_path / f"j_{run}{idx}.jsonl"
            n = getattr(mod_t, run)(PixelAgent(), qfile, imgs, str(ours), chunks, idx)
            assert n == getattr(mod_j, run)(PixelAgent(), qfile, imgs, str(want),
                                            chunks, idx)
            _same_file(ours, want)
    assert tvqa.summarize_answers(str(ours)) == jvqa.summarize_answers(str(want))


def test_jpeg_images_are_refused(vqa_files, tmp_path):
    """Only the JPEGs the port's decoder does not take are refused (a CMYK
    one: ROADMAP §1.1); a YCbCr JPEG gives the JAX harness's answers, and an
    MMBench row's JPEG decodes as Pillow decodes it."""
    qfile, imgs = vqa_files
    img = RNG.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    Image.fromarray(img).save(f"{imgs}/im0.jpg", quality=85)
    Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(f"{imgs}/im1.jpg")
    q = tmp_path / "jq.jsonl"
    q.write_text(json.dumps({"question_id": 0, "image": "im0.jpg", "text": "?"}) + "\n")
    tvqa.run_vqa(PixelAgent(), str(q), imgs, str(tmp_path / "a.jsonl"))
    jvqa.run_vqa(PixelAgent(), str(q), imgs, str(tmp_path / "ja.jsonl"))
    _same_file(tmp_path / "a.jsonl", tmp_path / "ja.jsonl")
    q.write_text(json.dumps({"question_id": 1, "image": "im1.jpg", "text": "?"}) + "\n")
    with pytest.raises(ValueError, match=r"im1\.jpg: a CMYK .*ROADMAP §1\.1"):
        tvqa.run_vqa(PixelAgent(), str(q), imgs, str(tmp_path / "b.jsonl"))
    with pytest.raises(ValueError, match=r"im1\.jpg: a CMYK .*ROADMAP §1\.1"):
        tgen.run_vqa_loader(PixelAgent(), str(q), imgs, str(tmp_path / "c.jsonl"))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    assert np.array_equal(
        tgen._decode_b64_image(base64.b64encode(buf.getvalue()).decode()),
        np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))


def _mmbench_tsv(path):
    cols = ["index", "question", "hint", "A", "B", "C", "D", "image", "answer"]
    rows = [
        {"index": "q1", "question": "Which animal?", "hint": "Look closely.",
         "A": "cat", "B": "dog", "C": "bird", "D": "fish", "answer": "B",
         "image": base64.b64encode(_png_bytes(
             RNG.integers(0, 256, (9, 7, 3), dtype=np.uint8))).decode()},
        {"index": "q2", "question": "Day or night?", "hint": "nan",
         "A": "day", "B": "night", "C": "", "D": "", "answer": "A",
         "image": base64.b64encode(_png_bytes(
             RNG.integers(0, 256, (5, 6), dtype=np.uint8))).decode()},
    ]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, delimiter="\t")
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return {r["index"]: r["answer"] for r in rows}


def test_mmbench_and_science_qa_match_jax(tmp_path):
    tsv = str(tmp_path / "mm.tsv")
    truths = _mmbench_tsv(tsv)
    for kw in ({}, {"all_rounds": False, "lang": "cn"}):
        ours, want = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
        assert tgen.run_mmbench(PixelAgent(), tsv, str(ours), **kw) == \
            jgen.run_mmbench(PixelAgent(), tsv, str(want), **kw)
        _same_file(ours, want)
        recs = [json.loads(line) for line in open(ours)]
        assert tgen.mmbench_circular_accuracy(recs, truths) == \
            jgen.mmbench_circular_accuracy(recs, truths)
    imgs = tmp_path / "sqa"
    imgs.mkdir()
    write_png(str(imgs / "a.png"), RNG.integers(0, 256, (6, 6, 3), dtype=np.uint8))
    probs = [{"id": "p1", "image": "a.png",
              "conversations": [{"value": "<image>\nWhich? A. x B. y"}]},
             {"id": "p2", "conversations": [{"value": "Text only? A. u B. v"}]}]
    qf = tmp_path / "sqa.json"
    qf.write_text(json.dumps(probs))
    for single in (True, False):
        ours, want = tmp_path / "ts.jsonl", tmp_path / "js.jsonl"
        tgen.run_science_qa(PixelAgent(), str(qf), str(imgs), str(ours), single)
        jgen.run_science_qa(PixelAgent(), str(qf), str(imgs), str(want), single)
        _same_file(ours, want)


def test_science_qa_requery_and_scorers_match_jax(tmp_path):
    problems = {f"p{i}": {"choices": ["a", "b", "c"][: 2 + i % 2], "answer": i % 2}
                for i in range(6)}
    texts = ["The answer is A.", "The answer is B.", "no idea", "The answer is C.",
             "The answer is A. The answer is B.", "B"]
    ours_pred = {k: {"text": t} for k, t in zip(problems, texts)}
    requery = {k: {"text": t} for k, t in list(zip(problems, texts[::-1]))[:4]}
    gpt4 = dict(zip(problems, texts[1:] + texts[:1]))
    args = (problems, list(problems), ours_pred, requery, gpt4)
    assert tgen.science_qa_requery_eval(*args, seed=3) == \
        jgen.science_qa_requery_eval(*args, seed=3)
    answers = ["Yes, there is.", "No.", "not sure", "I think no, it is not", "yes"]
    labels = ["yes", "no", "yes", "no", "no"]
    assert tscorers.pope_metrics(answers, labels) == jscorers.pope_metrics(answers, labels)
    for t in texts + ["(C) maybe", "E", " b. "]:
        assert tscorers.parse_multiple_choice(t) == jscorers.parse_multiple_choice(t)
        assert tgen.parse_sqa_answer(t) == jgen.parse_sqa_answer(t)
    gts = ["two"] * 4 + ["2"] * 3 + ["three", "a two", "Two!"]
    preds = ["2", "two", "Two.", "three", "the 2", "won't", "10,000"]
    for p in preds:
        assert tproto.process_answer(p) == jproto.process_answer(p)
        assert tscorers.vqa_accuracy(p, gts) == jscorers.vqa_accuracy(p, gts)
        assert tproto.anls(p, "two") == jproto.anls(p, "two")
    pl = [{"pred_answer": p, "gt_answers": gts} for p in preds]
    for fn in ("textvqa_eval", "stvqa_eval", "stvqa_anls_eval"):
        assert getattr(tproto, fn)(pl) == getattr(jproto, fn)(pl)
    assert tscorers.textvqa_accuracy(preds, [gts] * len(preds)) == \
        jscorers.textvqa_accuracy(preds, [gts] * len(preds))


def _driver_files(tmp_path):
    ann = {"data": [{"image_id": 0, "question": "Is there a cat?", "answers": ["yes"] * 10},
                    {"image_id": 1, "question": "What colour?",
                     "answers": ["red"] * 6 + ["blue"] * 4}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    res = [{"question_id": 0, "prompt": "Is there a cat?\nAnswer briefly.", "text": "Yes"},
           {"question_id": 1, "prompt": "What colour?\nAnswer briefly.", "text": "Blue."}]
    (tmp_path / "res").mkdir()
    (tmp_path / "res" / "a.jsonl").write_text("".join(json.dumps(r) + "\n" for r in res))
    (tmp_path / "res" / "skip.txt").write_text("")
    ann_dir = tmp_path / "pope"
    ann_dir.mkdir()
    for cat, labels in (("popular", ["yes", "no"]), ("random", ["no", "no"])):
        (ann_dir / f"coco_pope_{cat}.json").write_text(
            "".join(json.dumps({"label": lab}) + "\n" for lab in labels))
    q = [{"question_id": i, "category": c}
         for i, c in enumerate(["popular", "popular", "random", "random"])]
    (tmp_path / "q.jsonl").write_text("".join(json.dumps(x) + "\n" for x in q))
    r = [{"question_id": i, "text": t} for i, t in enumerate(["Yes.", "No", "yes", "No."])]
    (tmp_path / "r.jsonl").write_text("".join(json.dumps(x) + "\n" for x in r))


def test_drivers_cli_output_matches_jax(tmp_path, capsys):
    _driver_files(tmp_path)
    argvs = [["textvqa", "--annotation-file", str(tmp_path / "ann.json"),
              "--result-dir", str(tmp_path / "res")],
             ["pope", "--annotation-dir", str(tmp_path / "pope"),
              "--question-file", str(tmp_path / "q.jsonl"),
              "--result-file", str(tmp_path / "r.jsonl")], []]
    for argv in argvs:
        rc = tdrivers.main(argv)
        ours = capsys.readouterr().out
        assert rc == jdrivers.main(argv)
        want = capsys.readouterr().out
        assert ours == want.replace("faithdiff_tpu.eval", "faithdiff_tpu_torch.eval")


def _backend(content, system, max_tokens):
    n = len(content)
    return f"{n % 10} {(n // 10) % 10}\nreviewed {system[:8]} {max_tokens}"


def test_review_commands_match_jax(tmp_path, capsys):
    assert treview.DEFAULT_RULES == jreview.DEFAULT_RULES
    qs = [{"question_id": i, "text": f"q{i}?", "category": c, "image": f"i{i % 2}.png"}
          for i, c in enumerate(["conv", "detail", "complex", "default"])]
    a1 = [{"question_id": i, "answer_id": f"a{i}", "text": f"ans {i}"} for i in range(4)]
    a2 = [{"question_id": i, "text": f"other {i} " * i} for i in range(4)]
    ctx = [{"image": f"i{k}.png", "captions": ["c1", "c2"], "caption": ["c1", "c2"],
            "instances": [{"category": "cat", "bbox": [0, 0, 1, 1]}]} for k in range(2)]
    for name, rows in (("q", qs), ("a1", a1), ("a2", a2), ("ctx", ctx)):
        (tmp_path / f"{name}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (tmp_path / "qa.jsonl").write_text("".join(
        json.dumps({"question_id": i, "text": f"q{i}?"}) + "\n" for i in range(4)))
    backend = "test_torch_eval_vqa:_backend"
    p = str(tmp_path)
    runs = [["review", "-q", f"{p}/q.jsonl", "-a", f"{p}/a1.jsonl", f"{p}/a2.jsonl",
             "-c", f"{p}/ctx.jsonl", "--backend", backend, "-o", "{out}"],
            ["review-bench", "-q", f"{p}/q.jsonl", "-c", f"{p}/ctx.jsonl",
             "-a", f"{p}/a1.jsonl", f"{p}/a2.jsonl", "--backend", backend,
             "-r", f"{p}/rules.json", "-o", "{out}"],
            ["qa-baseline", "-q", f"{p}/qa.jsonl", "--backend", backend, "-o", "{out}"]]
    rules = {f"llava_bench_{c}": {"role": "Assistant", "prompt": f"rate {c}"}
             for c in ("conv", "detail", "complex", "default")}
    (tmp_path / "rules.json").write_text(json.dumps(rules))
    for k, argv in enumerate(runs):
        outs = []
        for side, mod in (("t", treview), ("j", jreview)):
            out = str(tmp_path / f"{side}{k}.jsonl")
            mod.main([a.replace("{out}", out) for a in argv])
            outs.append(out)
        capsys.readouterr()
        _same_file(*outs)
    tables = []
    for side, mod in (("t", treview), ("j", jreview)):
        mod.main(["summarize", "-f", str(tmp_path / f"{side}0.jsonl")])
        tables.append(capsys.readouterr().out.split("\n", 1)[1])  # past the name
    assert tables[0] == tables[1] and "relative=" in tables[0]


def test_run_vqa_with_the_port_caption_agent(vqa_files, tmp_path):
    """The port's CaptionAgent (tiny LLaMA and CLIP tower, seeded) answers
    through `run_vqa` on the CPU; JAX's `run_vqa`, replaying those answers
    for the same images and questions, writes the same file."""
    torch.manual_seed(0)
    vcfg, lcfg = tc.tiny_vision_config(), tl.LlamaConfig.tiny()
    agent = ta.CaptionAgent(
        llama=tl.LlamaForCausalLM(lcfg).eval(), vision=tc.CLIPVisionTower(vcfg).eval(),
        projector=tc.VisionProjector(lcfg.hidden_size, vcfg.hidden_size).eval(),
        tokenizer=StubTokenizer(), max_new_tokens=4, temperature=0.0)
    qfile, imgs = vqa_files
    ours = tmp_path / "ours.jsonl"
    assert tvqa.run_vqa(agent, qfile, imgs, str(ours), max_questions=3) == 3
    answers = [json.loads(line)["text"] for line in open(ours)]
    assert all(isinstance(a, str) for a in answers)

    class Replay:
        def caption(self, image, question):
            return agent.caption(image, question=question)

    want = tmp_path / "want.jsonl"
    jvqa.run_vqa(Replay(), qfile, imgs, str(want), max_questions=3)
    _same_file(ours, want)
