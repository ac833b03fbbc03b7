"""LLaMA's SentencePiece tokenizer without the sentencepiece, protobuf or
transformers packages (counterpart of the `AutoTokenizer` that
`faithdiff_tpu/captioner/agent.py` loads from `<ckpt>/tokenizer`).

`tokenizer.model` is a protobuf `ModelProto`, read here from its wire
format: `pieces` (1: `piece` 1, `score` 2, `type` 3), `trainer_spec` (2:
`model_type` 3, `byte_fallback` 35, `unk_id` 40, `bos_id` 41, `eos_id` 42,
`pad_id` 43) and `normalizer_spec` (3: `add_dummy_prefix` 3,
`remove_extra_whitespaces` 4). `tokenizer_config.json` (`add_bos_token`,
`add_eos_token`, `legacy`, the four special tokens) and
`special_tokens_map.json` are read when they exist; a directory that asks
for `clean_up_tokenization_spaces` or `additional_special_tokens` (LLaVA's
asks for neither) is refused.

Encoding gives the ids of transformers' `LlamaTokenizerFast` built from the
same file (the tokenizer the JAX package loads):

1. the text is split around the added tokens (control pieces, BOS, EOS,
   UNK, PAD), leftmost and longest first; each maps to its id;
2. in each other segment spaces become `▁`; with `legacy` (the default
   when the config does not say) every segment gets a `▁` in front, without
   it only a segment at the start of the text that does not begin with `▁`
   (the fast tokenizer's Metaspace "first" scheme); `add_dummy_prefix`
   false gives none. `remove_extra_whitespaces` is read and not applied:
   the fast tokenizer's converter does not apply it either (LLaMA's file
   sets it false);
3. SentencePiece BPE: starting from the segment's characters, the adjacent
   pair whose joined piece is a normal piece of the highest score merges,
   the leftmost on a tie, until no pair joins into a piece;
4. a symbol that is no piece falls back to the `<0xNN>` pieces of its UTF-8
   bytes (`byte_fallback`), else to UNK (a run of UNKs fuses into one).

Decoding skips the special ids on request, joins runs of byte pieces into
UTF-8 (U+FFFD for each byte of an invalid run), turns `▁` into a space and
drops one leading space. `save_sentencepiece_model` writes the same wire
format, so that a vocabulary can be made where protobuf is not installed.
Standard library and numpy only.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import re
import struct
import types
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

SPACE = "▁"
# SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, BYTE = 1, 2, 3, 6
# TrainerSpec.ModelType
UNIGRAM, BPE = 1, 2
_BYTE_PIECE = re.compile(r"<0x([0-9A-Fa-f]{2})>")
_SPECIAL_NAMES = ("bos_token", "eos_token", "unk_token", "pad_token")


@dataclasses.dataclass
class SentencePieceModel:
    """The fields of `ModelProto` the tokenizer needs, with the proto's
    defaults."""

    pieces: List[Tuple[str, float, int]]        # (piece, score, type)
    model_type: int = UNIGRAM
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("tokenizer.model: truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("tokenizer.model: varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of one message: an int for varint
    and fixed fields, the raw bytes of a length-delimited one."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"tokenizer.model: wire type {wire} of field {field}")
        if pos > len(buf):
            raise ValueError(f"tokenizer.model: field {field} runs past the end")
        yield field, wire, value


def _int32(value: int) -> int:
    """A varint read as int32 (negative values are ten-byte varints)."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


def parse_sentencepiece_model(data: bytes) -> SentencePieceModel:
    """`ModelProto` bytes -> the fields the tokenizer reads."""
    model = SentencePieceModel(pieces=[])
    trainer = {3: "model_type", 35: "byte_fallback", 40: "unk_id", 41: "bos_id",
               42: "eos_id", 43: "pad_id"}
    normalizer = {3: "add_dummy_prefix", 4: "remove_extra_whitespaces"}
    for field, wire, value in _fields(data):
        if field == 1 and wire == 2:
            piece, score, kind = "", 0.0, NORMAL
            for f, w, v in _fields(value):
                if f == 1 and w == 2:
                    piece = v.decode("utf-8")
                elif f == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
                elif f == 3 and w == 0:
                    kind = v
            model.pieces.append((piece, score, kind))
        elif field in (2, 3) and wire == 2:
            names = trainer if field == 2 else normalizer
            for f, w, v in _fields(value):
                if f in names and w == 0:
                    name = names[f]
                    setattr(model, name, bool(v) if isinstance(
                        getattr(model, name), bool) else _int32(v))
    if not model.pieces:
        raise ValueError("tokenizer.model: no pieces")
    return model


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _message(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def save_sentencepiece_model(path: str, pieces: Sequence[Tuple[str, float, int]],
                             remove_extra_whitespaces: bool = False) -> None:
    """Write a `ModelProto` of `pieces` ((piece, score, type), in id order)
    that SentencePiece and protobuf read, with LLaMA's settings: BPE, byte
    fallback, UNK / BOS / EOS at 0 / 1 / 2, no PAD, a dummy prefix."""
    out = bytearray()
    for piece, score, kind in pieces:
        out += _message(1, _message(1, piece.encode("utf-8"))
                        + _tag(2, 5) + struct.pack("<f", score)
                        + _tag(3, 0) + _varint(kind))
    trainer = (_tag(3, 0) + _varint(BPE) + _tag(4, 0) + _varint(len(pieces))
               + _tag(35, 0) + _varint(1)
               + _tag(40, 0) + _varint(0) + _tag(41, 0) + _varint(1)
               + _tag(42, 0) + _varint(2) + _tag(43, 0) + _varint(-1))
    normalizer = (_message(1, b"identity") + _tag(3, 0) + _varint(1)
                  + _tag(4, 0) + _varint(int(remove_extra_whitespaces))
                  + _tag(5, 0) + _varint(1))
    out += _message(2, trainer) + _message(3, normalizer)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

def _token_content(value) -> Optional[str]:
    return value.get("content") if isinstance(value, dict) else value


class LlamaTokenizer:
    """SentencePiece BPE tokenizer with the HF call interface the caption
    agent uses: `tok(text, add_special_tokens=True, return_tensors="np")
    .input_ids`, `tok.decode(ids, skip_special_tokens=True)`,
    `tok.eos_token_id`."""

    def __init__(self, model: SentencePieceModel, legacy: bool = True,
                 add_bos_token: bool = True, add_eos_token: bool = False,
                 special_tokens: Optional[Dict[str, Optional[str]]] = None):
        if model.model_type != BPE:
            raise ValueError(f"tokenizer.model: model_type {model.model_type} "
                             "(only BPE, 2, is read: LLaMA's)")
        self.model = model
        self.legacy, self.add_bos_token, self.add_eos_token = (
            legacy, add_bos_token, add_eos_token)
        self.pieces = [p for p, _, _ in model.pieces]
        self.vocab: Dict[str, int] = {}
        for i, piece in enumerate(self.pieces):
            self.vocab.setdefault(piece, i)
        kinds = [k for _, _, k in model.pieces]
        # pieces a symbol may end as, and those a pair may merge into
        self.known = {p: i for p, i in self.vocab.items()
                      if kinds[i] == NORMAL}
        self.merge_score = {p: model.pieces[i][1] for p, i in self.vocab.items()
                            if kinds[i] == NORMAL and len(p) > 1}
        self.byte_ids: Dict[int, int] = {}
        for i, (piece, _, kind) in enumerate(model.pieces):
            m = _BYTE_PIECE.fullmatch(piece)
            if kind == BYTE and m:
                self.byte_ids.setdefault(int(m.group(1), 16), i)
        self.byte_value = {i: b for b, i in self.byte_ids.items()}

        def piece_at(idx):
            return self.pieces[idx] if 0 <= idx < len(self.pieces) else None

        specials = {"bos_token": piece_at(model.bos_id),
                    "eos_token": piece_at(model.eos_id),
                    "unk_token": piece_at(model.unk_id),
                    "pad_token": piece_at(model.pad_id)}
        specials.update(special_tokens or {})
        ids = {name: self.vocab.get(tok) if tok is not None else None
               for name, tok in specials.items()}
        self.bos_token_id = ids["bos_token"]
        self.eos_token_id = ids["eos_token"]
        self.unk_token_id = ids["unk_token"]
        self.pad_token_id = ids["pad_token"]
        # added tokens: split out of the text before anything else
        self.added = {self.pieces[i]: i for i, k in enumerate(kinds)
                      if k == CONTROL}
        self.special_ids = {i for i, k in enumerate(kinds) if k == CONTROL}
        for tok in specials.values():
            if tok is not None and tok in self.vocab:
                self.added[tok] = self.vocab[tok]
                self.special_ids.add(self.vocab[tok])
        self._split = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)

    @classmethod
    def from_pretrained(cls, path: str) -> "LlamaTokenizer":
        """A tokenizer directory: `tokenizer.model`, and the
        `tokenizer_config.json` / `special_tokens_map.json` beside it where
        they exist (the latter over the former, as transformers reads
        them)."""
        with open(os.path.join(path, "tokenizer.model"), "rb") as f:
            model = parse_sentencepiece_model(f.read())
        config: dict = {}
        specials: Dict[str, Optional[str]] = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            full = os.path.join(path, name)
            if not os.path.exists(full):
                continue
            with open(full, encoding="utf-8") as f:
                cfg = json.load(f)
            if name == "tokenizer_config.json":
                config = cfg
            for key in _SPECIAL_NAMES:
                if cfg.get(key) is not None:
                    specials[key] = _token_content(cfg[key])
            if cfg.get("clean_up_tokenization_spaces") or cfg.get(
                    "additional_special_tokens"):
                raise ValueError(f"{full}: clean_up_tokenization_spaces and "
                                 "additional_special_tokens are not read")
        legacy = config.get("legacy")
        return cls(model, legacy=True if legacy is None else bool(legacy),
                   add_bos_token=bool(config.get("add_bos_token", True)),
                   add_eos_token=bool(config.get("add_eos_token", False)),
                   special_tokens=specials)

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            return self.pieces[int(ids)]
        return [self.pieces[int(i)] for i in ids]

    # -- encoding ---------------------------------------------------------

    def _segments(self, text: str) -> Iterator[Tuple[str, int, bool]]:
        """(piece, offset in the text, is an added token)."""
        pos = 0
        if self._split is not None:
            for m in self._split.finditer(text):
                if m.start() > pos:
                    yield text[pos:m.start()], pos, False
                yield m.group(), m.start(), True
                pos = m.end()
        if pos < len(text):
            yield text[pos:], pos, False

    def _normalize(self, segment: str, offset: int) -> str:
        if self.legacy:
            if self.model.add_dummy_prefix and segment:
                segment = SPACE + segment
            return segment.replace(" ", SPACE)
        segment = segment.replace(" ", SPACE)
        if self.model.add_dummy_prefix and offset == 0 and not segment.startswith(SPACE):
            segment = SPACE + segment
        return segment

    def _bpe(self, text: str) -> List[str]:
        """SentencePiece BPE over the characters of `text`: the best-scoring
        mergeable adjacent pair first, the leftmost on a tie."""
        n = len(text)
        sym = list(text)
        nxt = list(range(1, n)) + [-1]
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap: List[Tuple[float, int, str, str]] = []

        def push(i):
            j = nxt[i]
            if j >= 0:
                score = self.merge_score.get(sym[i] + sym[j])
                if score is not None:
                    heapq.heappush(heap, (-score, i, sym[i], sym[j]))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, left, right = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j < 0 or sym[i] != left or sym[j] != right:
                continue                              # a stale pair
            sym[i] = left + right
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)
        return [s for s, a in zip(sym, alive) if a]

    def _piece_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for s in self._bpe(text):
            if s in self.known:
                ids.append(self.known[s])
                continue
            raw = s.encode("utf-8")
            if self.model.byte_fallback and all(b in self.byte_ids for b in raw):
                ids.extend(self.byte_ids[b] for b in raw)
            elif not (ids and ids[-1] == self.unk_token_id):
                ids.append(self.unk_token_id)
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for segment, offset, added in self._segments(text):
            if added:
                ids.append(self.added[segment])
            else:
                ids.extend(self._piece_ids(self._normalize(segment, offset)))
        if add_special_tokens:
            if self.add_bos_token and self.bos_token_id is not None:
                ids.insert(0, self.bos_token_id)
            if self.add_eos_token and self.eos_token_id is not None:
                ids.append(self.eos_token_id)
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True,
                 return_tensors: Optional[str] = None):
        """`.input_ids`: the list of ids, or an int64 numpy array [1, L]
        under `return_tensors="np"`."""
        if return_tensors not in (None, "np"):
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np'")
        ids = self.encode(text, add_special_tokens)
        if return_tensors == "np":
            ids = np.asarray([ids], np.int64)
        return types.SimpleNamespace(input_ids=ids)

    # -- decoding ---------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        run = bytearray()

        def flush():
            if run:
                try:
                    out.append(run.decode("utf-8"))
                except UnicodeDecodeError:
                    out.append("�" * len(run))
                run.clear()

        for i in np.asarray(ids, np.int64).ravel().tolist():
            if not 0 <= i < len(self.pieces) or (
                    skip_special_tokens and i in self.special_ids):
                continue
            if i in self.byte_value:
                run.append(self.byte_value[i])
                continue
            flush()
            out.append(self.pieces[i].replace(SPACE, " "))
        flush()
        text = "".join(out)
        if self.model.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text
