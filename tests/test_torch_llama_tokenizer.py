"""The port's SentencePiece tokenizer (`faithdiff_tpu_torch/captioner/
llama_tokenizer.py`) against transformers' `LlamaTokenizerFast` built from
the same `tokenizer.model`, the tokenizer the JAX package's
`AutoTokenizer` gives for LLaMA's files.

The sandbox has no `sentencepiece`, so the yardstick is built the way
`LlamaTokenizerFast.from_pretrained` converts a slow tokenizer, with the
proto read by protobuf: `LlamaConverter` over a shim with `vocab_file` and
`convert_ids_to_tokens`, its `SpmExtractor` replaced by one that takes the
vocabulary from the proto and the merges from `generate_merges`. The
vocabulary is trained here: BPE merges over a corpus holding the caption
prompt, 256 byte pieces, `<unk>` / `<s>` / `</s>` at 0 / 1 / 2."""
import json
import os
import random

import numpy as np
import pytest

pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")

from faithdiff_tpu_torch.captioner.agent import (DEFAULT_QUESTION,  # noqa: E402
                                                 build_vicuna_prompt)
from faithdiff_tpu_torch.captioner.llama_tokenizer import (  # noqa: E402
    LlamaTokenizer, parse_sentencepiece_model, save_sentencepiece_model)
from port_parity import fast_llama_tokenizer, llama_pieces  # noqa: E402

CORPUS = " ".join(build_vicuna_prompt(DEFAULT_QUESTION)) + (
    " the image shows a red house with a white door, and a cat sitting in "
    "the sun. It's a photo of the old town: bright colors, soft light!")
PRE, POST = build_vicuna_prompt(DEFAULT_QUESTION)
TEXTS = [
    PRE, POST, "</s>", "  two leading spaces", " one leading space",
    "doubled  spaces  here", "trailing spaces  ", "line one\nline two\n\nend",
    "\ttabbed\r\n", "héllo wörld, naïve café", "日本語のテキスト 😀 ok", "", " ",
    "<s>hi</s> there<unk> again", "x</s>y", "a</s></s>b", "USER: <image>",
    "The image shows a red house. The sun is bright!",
]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("llama_tok") / "tokenizer.model")
    save_sentencepiece_model(path, llama_pieces(CORPUS))
    return path


def _pair(path, legacy, add_dummy_prefix=True):
    if not add_dummy_prefix:
        with open(path, "rb") as f:
            proto = pb.ModelProto.FromString(f.read())
        proto.normalizer_spec.add_dummy_prefix = False
        path = path.replace("tokenizer.model", "no_prefix.model")
        with open(path, "wb") as f:
            f.write(proto.SerializeToString())
    with open(path, "rb") as f:
        ours = LlamaTokenizer(parse_sentencepiece_model(f.read()), legacy=legacy)
    return fast_llama_tokenizer(path, legacy, add_dummy_prefix), ours


def test_written_model_parses_back_with_protobuf(model_path):
    pieces = llama_pieces(CORPUS)
    with open(model_path, "rb") as f:
        proto = pb.ModelProto.FromString(f.read())
    assert [(p.piece, p.score, p.type) for p in proto.pieces] == [
        (s, float(np.float32(v)), k) for s, v, k in pieces]
    spec = proto.trainer_spec
    assert (spec.model_type, spec.byte_fallback, spec.unk_id, spec.bos_id,
            spec.eos_id, spec.pad_id) == (2, True, 0, 1, 2, -1)
    assert proto.normalizer_spec.add_dummy_prefix
    assert not proto.normalizer_spec.remove_extra_whitespaces
    with open(model_path, "rb") as f:
        ours = parse_sentencepiece_model(f.read())
    assert [(p, np.float32(s), k) for p, s, k in ours.pieces] == [
        (p.piece, np.float32(p.score), p.type) for p in proto.pieces]
    assert (ours.pad_id, ours.byte_fallback, ours.remove_extra_whitespaces) == (-1, True, False)


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("case", range(len(TEXTS)))
def test_ids_and_decode_equal_the_fast_tokenizer(model_path, legacy, case):
    fast, ours = _pair(model_path, legacy)
    text = TEXTS[case]
    for special in (True, False):
        want = fast(text, add_special_tokens=special).input_ids
        assert ours(text, add_special_tokens=special).input_ids == want
    ids = fast(text).input_ids
    for skip in (True, False):
        assert ours.decode(ids, skip_special_tokens=skip) == \
            fast.decode(ids, skip_special_tokens=skip)
    got = ours(text, return_tensors="np").input_ids
    assert got.dtype == np.int64 and got.tolist() == [ids]


def test_stop_sequence_and_prompt_segments(model_path):
    """`</s>` alone is the eos id (the agent's keyword stop); the segment
    after the image slot starts with `▁` then the newline's byte piece."""
    _, ours = _pair(model_path, True)
    assert ours("</s>", add_special_tokens=False).input_ids == [2]
    assert ours.eos_token_id == 2 and ours.bos_token_id == 1
    post = ours(POST, add_special_tokens=False).input_ids
    assert ours.convert_ids_to_tokens(post[:2]) == ["▁", "<0x0A>"]
    assert ours(PRE).input_ids[0] == 1


@pytest.mark.parametrize("legacy", [True, False])
def test_random_text_and_ids_equal_the_fast_tokenizer(model_path, legacy):
    """Seeded random strings over the corpus' characters, spaces, newlines,
    specials and characters outside the vocabulary; random id sequences
    decoded with and without the specials."""
    fast, ours = _pair(model_path, legacy)
    rng = random.Random(7)
    alphabet = list(set(CORPUS)) + [" ", " ", "\n", "é", "ß", "€", "😀", "</s>", "<s>"]
    for _ in range(40):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
        assert ours(text).input_ids == fast(text).input_ids, repr(text)
    for _ in range(40):
        ids = [rng.randrange(len(ours.pieces)) for _ in range(rng.randint(0, 30))]
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                fast.decode(ids, skip_special_tokens=skip), ids


def test_no_dummy_prefix_equals_the_fast_tokenizer(model_path):
    fast, ours = _pair(model_path, True, add_dummy_prefix=False)
    for text in (PRE, POST, " lead", "a b"):
        assert ours(text).input_ids == fast(text).input_ids
        ids = fast(text).input_ids
        assert ours.decode(ids, skip_special_tokens=True) == \
            fast.decode(ids, skip_special_tokens=True)


def test_from_pretrained_reads_the_json_files(model_path, tmp_path):
    """`tokenizer_config.json` (flags, a special token as a dict) and
    `special_tokens_map.json` as LLaVA ships them (pad = `<unk>`)."""
    d = tmp_path / "tok"
    d.mkdir()
    with open(model_path, "rb") as f:
        (d / "tokenizer.model").write_bytes(f.read())
    (d / "tokenizer_config.json").write_text(json.dumps({
        "add_bos_token": True, "add_eos_token": True, "legacy": False,
        "eos_token": {"content": "</s>", "lstrip": False, "rstrip": False},
        "clean_up_tokenization_spaces": False}))
    (d / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
        "pad_token": "<unk>"}))
    tok = LlamaTokenizer.from_pretrained(str(d))
    assert (tok.legacy, tok.add_eos_token, tok.pad_token_id) == (False, True, 0)
    ids = tok(" hello").input_ids
    assert ids[0] == 1 and ids[-1] == 2
    assert tok.decode(ids, skip_special_tokens=True) == "hello"
    os.remove(d / "tokenizer_config.json")
    assert LlamaTokenizer.from_pretrained(str(d)).legacy
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"clean_up_tokenization_spaces": True}))
    with pytest.raises(ValueError, match="not read"):
        LlamaTokenizer.from_pretrained(str(d))


def test_remove_extra_whitespaces_is_read_and_not_applied(model_path, tmp_path):
    """A file that sets `remove_extra_whitespaces` (LLaMA's does not) gives
    the fast tokenizer's ids, which keep every space."""
    path = str(tmp_path / "tokenizer.model")
    save_sentencepiece_model(path, llama_pieces(CORPUS), remove_extra_whitespaces=True)
    fast, ours = _pair(path, True)
    assert ours.model.remove_extra_whitespaces
    for text in ("  the   image  ", "trailing spaces  ", POST):
        assert ours(text).input_ids == fast(text).input_ids, repr(text)
