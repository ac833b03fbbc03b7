"""The port's CLIP BPE (`faithdiff_tpu_torch.models.tokenizer`) against
transformers' slow `CLIPTokenizer`, through the JAX package's
`SDXLTokenizer`, on tokenizer directories the test writes in SDXL's
layout: a vocabulary of the 256 byte symbols, the same with `</w>`,
merges that build lower-case ASCII words and a few Latin-1 and CJK
pieces, and the two specials; `tokenizer_2` pads with `!` (id 0), as
SDXL's does. Ids must be equal, on hand-picked prompts and on hypothesis
text (unicode letters and digits, accents, CJK, control characters,
apostrophes, punctuation runs, the special strings, prompts past 77
tokens)."""
import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from faithdiff_tpu.models.tokenizer import SDXLTokenizer as JaxSDXLTokenizer
from faithdiff_tpu_torch.models.tokenizer import (CLIPBPE, HashTokenizer,
                                                  SDXLTokenizer,
                                                  bytes_to_unicode,
                                                  pad_token_ids)

LETTERS = "etaoinshrdlcumwfgypbvkjxqz"


def write_tokenizer_dirs(root):
    """Byte symbols, byte symbols + `</w>`, merges of lower-case ASCII
    words of up to three letters plus a few multi-byte pieces (ranks in
    the order made), the specials last."""
    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    seen = set(vocab)
    merges, words = [], list(LETTERS[:14])
    enc = bytes_to_unicode()
    extra = ["é", "ü", "中", "文"]          # pieces of their UTF-8 bytes
    for ch in extra:
        b = [enc[x] for x in ch.encode()]
        merges.append(f"{b[0]} {b[1]}")
        vocab.append(b[0] + b[1])
    for word in words:
        for b in LETTERS[:14]:
            for second in (b, b + "</w>"):
                token = word + second
                if token in seen:
                    continue
                seen.add(token)
                merges.append(f"{word} {second}")
                vocab.append(token)
                if len(token) < 3:
                    words.append(token)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    special = {k: {"content": v, "lstrip": False, "normalized": True,
                   "rstrip": False, "single_word": False}
               for k, v in (("bos_token", "<|startoftext|>"),
                            ("eos_token", "<|endoftext|>"),
                            ("unk_token", "<|endoftext|>"))}
    for name, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump({t: i for i, t in enumerate(vocab)}, f)
        with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
            json.dump(dict(special, pad_token=pad), f)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"do_lower_case": True, "model_max_length": 77,
                       "pad_token": pad, "errors": "replace",
                       "tokenizer_class": "CLIPTokenizer"}, f)
    return root


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    root = write_tokenizer_dirs(str(tmp_path_factory.mktemp("tok")))
    paths = (os.path.join(root, "tokenizer"), os.path.join(root, "tokenizer_2"))
    return SDXLTokenizer(*paths), JaxSDXLTokenizer(*paths)


def _same(tokenizers, prompts):
    port, ref = tokenizers
    got, want = port(prompts), ref(prompts)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (len(prompts), 77)
        np.testing.assert_array_equal(g, w)


PROMPTS = [
    "", "a photo of a red house", "Hello!! hello", "x!y ! !!", "HELLO<|endoftext|>x",
    "<|StartOfText|> hi", "a'ſ 'S b it'S we'Ll", "don't we're they've i'm you'll he'd",
    "中文 Café naïve résumé Ωμέγα ǅ", "tab\tnew\nline\r\x00nul\x07bell​zw",
    "3.14159 and 2nd, ½ Ⅻ ٣", "...???!!!---((()))", "   spaced   out   ",
    "Ｆｕｌｌｗｉｄｔｈ and emoji 🙂🙃",
    " ".join(["the tall green tree beside the old stone wall"] * 12),
]


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_ids_equal_transformers(tokenizers, prompt):
    _same(tokenizers, [prompt])


FRAGMENTS = ["'s", "'T", "'re", "'ve", "'m", "'ll", "'d", "'", "<|endoftext|>",
             "<|startoftext|>", "!", "!!", " ", "  ", "\n", "\t", "\x00", "\x7f",
             "́", "é", "中", "文字", "ſ", "K", "...", "--", "(x)", "2024"]
WORDS = ["the", "tall", "green", "tree", "cat", "sits", "on", "a", "red",
         "rug", "House", "DOOR", "window", "shines"]


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.one_of(
    st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=6),
    st.sampled_from(FRAGMENTS), st.sampled_from(WORDS),
    st.lists(st.sampled_from(WORDS), max_size=30).map(" ".join)),
    max_size=12).map("".join))
def test_ids_equal_transformers_on_any_text(tokenizers, text):
    _same(tokenizers, [text])


def test_batch_and_special_ids(tokenizers):
    """A batch tokenises row by row; BOS / EOS / pad come from the files:
    `tokenizer_2` pads with `!` (id 0) and keeps one EOS; a prompt past 77
    tokens keeps BOS ... EOS."""
    port, _ = tokenizers
    prompts = ["a red cat", " ".join(["tree"] * 100)]
    _same(tokenizers, prompts)
    ids_1, ids_2 = port(prompts)
    tok_1, tok_2 = port.tok_1, port.tok_2
    assert (tok_1.bos_id, tok_1.eos_id) == (tok_2.bos_id, tok_2.eos_id)
    assert tok_1.pad_id == tok_1.eos_id and tok_2.pad_id == 0
    n = len(tok_1.encode(prompts[0])) + 1
    assert ids_1[0, n:].tolist() == [tok_1.eos_id] * (77 - n)
    assert ids_2[0, n] == tok_2.eos_id and ids_2[0, n + 1:].tolist() == [0] * (76 - n)
    assert ids_1[1, 0] == tok_1.bos_id and ids_1[1, 76] == tok_1.eos_id
    assert (ids_1[1, 1:76] != tok_1.eos_id).all()


def test_special_token_missing_from_vocab_raises(tmp_path):
    d = tmp_path / "tok"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps({"a": 0, "<|endoftext|>": 1}))
    (d / "merges.txt").write_text("#version: 0.2\n")
    with pytest.raises(ValueError, match="startoftext"):
        CLIPBPE(str(d))


def test_hash_tokenizer_and_padding_match_jax():
    from faithdiff_tpu.models import tokenizer as jtok

    for vocab in (128, 49408):
        got = HashTokenizer(vocab)(["a red cat", ""])
        want = jtok.HashTokenizer(vocab)(["a red cat", ""])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    ids = np.arange(2 * 30, dtype=np.int32).reshape(2, 30)
    np.testing.assert_array_equal(pad_token_ids(ids), jtok.pad_token_ids(ids))
