"""The port's captioner data utilities (`training/caption_data.py`, its own
copy of the JAX package's module) against the JAX package's: the
length- and modality-grouped orders from the same numpy seed, the even
split, and `tokenizer_image_token` / `preprocess_conversation` giving the
same (input_ids, labels), the port with its SentencePiece tokenizer and
the JAX package with transformers' fast tokenizer of the same
`tokenizer.model`, legacy and not."""
import numpy as np
import pytest

from faithdiff_tpu.training import caption_data as jd
from faithdiff_tpu_torch.captioner.llama_tokenizer import (
    LlamaTokenizer, parse_sentencepiece_model, save_sentencepiece_model)
from faithdiff_tpu_torch.training import caption_data as td
from port_parity import fast_llama_tokenizer, llama_pieces

CORPUS = ("A chat between a curious user and an artificial intelligence "
          "assistant. The assistant gives helpful, detailed, and polite "
          "answers to the user's questions. USER: ASSISTANT: Describe the "
          "image. The image shows a red house with a cat on the roof.")
TURNS = [("<image>\nDescribe the image.", "The image shows a red house."),
         ("What is on the roof?", "A cat.")]


def _lengths(seed, n, mixed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 300, n)
    if mixed:
        lengths = np.where(rng.random(n) < 0.4, -lengths, lengths)
    return lengths.tolist()


@pytest.mark.parametrize("mixed", [False, True], ids=["lengths", "modality"])
@pytest.mark.parametrize("world_size,batch", [(1, 4), (2, 3), (4, 2)])
def test_grouped_indices_same_seed_same_order(mixed, world_size, batch):
    lengths = _lengths(world_size + batch, 37, mixed)
    jsamp = jd.LengthGroupedSampler(batch, world_size, lengths,
                                    rng=np.random.default_rng(7),
                                    group_by_modality=mixed)
    tsamp = td.LengthGroupedSampler(batch, world_size, lengths,
                                    rng=np.random.default_rng(7),
                                    group_by_modality=mixed)
    got, want = list(tsamp), list(jsamp)
    assert got == want and sorted(got) == list(range(37))
    assert len(tsamp) == 37


@pytest.mark.parametrize("n,chunks", [(12, 3), (10, 3), (8, 4)])
def test_split_to_even_chunks(n, chunks):
    lengths = _lengths(n, n, False)
    idx = list(range(n))
    assert (td.split_to_even_chunks(idx, lengths, chunks)
            == jd.split_to_even_chunks(idx, lengths, chunks))


def test_zero_length_is_refused():
    with pytest.raises(ValueError, match="zero length"):
        td.get_modality_length_grouped_indices([3, 0, -2], 1, 1)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cap_tok") / "tokenizer.model")
    save_sentencepiece_model(path, llama_pieces(CORPUS))
    return path


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("has_image", [True, False])
def test_preprocess_conversation_matches_jax(model_path, legacy, has_image):
    fast = fast_llama_tokenizer(model_path, legacy)
    with open(model_path, "rb") as f:
        ours = LlamaTokenizer(parse_sentencepiece_model(f.read()), legacy=legacy)
    turns = TURNS if has_image else [(u.replace("<image>\n", ""), a)
                                     for u, a in TURNS]
    want_ids, want_labels = jd.preprocess_conversation(
        turns, fast, has_image=has_image)
    got_ids, got_labels = td.preprocess_conversation(
        turns, ours, has_image=has_image)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_labels, want_labels)
    assert (got_ids == td.IMAGE_TOKEN_INDEX).sum() == int(has_image)
    assert (got_labels != td.IGNORE_INDEX).sum() > 0
    prompt = "USER: <image>\nDescribe. ASSISTANT:"
    assert (td.tokenizer_image_token(prompt, ours)
            == jd.tokenizer_image_token(prompt, fast))
