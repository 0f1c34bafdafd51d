"""The T5 tokenizer without sentencepiece: ``spiece.model`` or ``tokenizer.json``
-> a ``tokenizers`` Unigram pipeline.

Counterpart of trajectorycrafter_tpu/utils/tokenizer.py.  The checkpoint's
``tokenizer/`` folder holds ``tokenizer.json`` (read as is) or the
sentencepiece ``spiece.model``; from the latter this module assembles the
pipeline transformers' T5 converter builds (the charsmap normalizer, right
strip, runs of spaces to one U+2581, Metaspace, Unigram over the pieces and
the 100 ``<extra_id_*>`` sentinels, control and user pieces as added tokens,
a ``</s>`` post-processor), so the ids are HF's T5TokenizerFast's.

``spiece.model`` is a protobuf ``ModelProto``; the few fields the pipeline
needs are read here from the wire format, so neither ``sentencepiece`` nor
a protobuf schema module is needed.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple, Union

import torch

T5_EXTRA_IDS = 100
T5_MAX_LENGTH = 226  # the prompt length the DiT reads

# field numbers of sentencepiece_model.proto
_MODEL_PIECES, _MODEL_TRAINER_SPEC, _MODEL_NORMALIZER_SPEC = 1, 2, 3
_PIECE_PIECE, _PIECE_SCORE, _PIECE_TYPE = 1, 2, 3
_TRAINER_MODEL_TYPE, _TRAINER_UNK_ID = 3, 40
_NORMALIZER_CHARSMAP = 2
_UNIGRAM, _NORMAL, _CONTROL, _USER_DEFINED = 1, 1, 3, 4  # the proto's defaults and enums


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of one serialized message: an int
    for a varint, bytes for the other wire types."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire} (field {number})")
        if pos > len(buf):
            raise ValueError("truncated protobuf message")
        yield number, value


def _int32(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


@dataclass
class SpieceModel:
    """The fields of a sentencepiece ``ModelProto`` that the T5 pipeline reads."""

    pieces: List[Tuple[str, float, int]] = field(default_factory=list)  # (piece, score, type)
    model_type: int = _UNIGRAM
    unk_id: int = 0
    precompiled_charsmap: bytes = b""


def read_spiece(data: bytes) -> SpieceModel:
    """Parse a serialized ``spiece.model`` (repeated sub-messages of the
    same non-repeated field merge, as protobuf merges them)."""
    model = SpieceModel()
    for number, value in _fields(data):
        if number == _MODEL_PIECES:
            piece, score, kind = "", 0.0, _NORMAL
            for n, v in _fields(value):
                if n == _PIECE_PIECE:
                    piece = v.decode("utf-8")
                elif n == _PIECE_SCORE:
                    (score,) = struct.unpack("<f", v)
                elif n == _PIECE_TYPE:
                    kind = v
            model.pieces.append((piece, score, kind))
        elif number == _MODEL_TRAINER_SPEC:
            for n, v in _fields(value):
                if n == _TRAINER_MODEL_TYPE:
                    model.model_type = v
                elif n == _TRAINER_UNK_ID:
                    model.unk_id = _int32(v)
        elif number == _MODEL_NORMALIZER_SPEC:
            for n, v in _fields(value):
                if n == _NORMALIZER_CHARSMAP:
                    model.precompiled_charsmap = bytes(v)
    return model


def _tokenizer_from_spiece(spiece_path: str):
    from tokenizers import AddedToken, Regex, Tokenizer, normalizers, pre_tokenizers
    from tokenizers.models import Unigram
    from tokenizers.processors import TemplateProcessing

    with open(spiece_path, "rb") as f:
        proto = read_spiece(f.read())
    if proto.model_type != _UNIGRAM:
        raise ValueError(f"{spiece_path}: not a Unigram sentencepiece model "
                         f"(model_type={proto.model_type})")

    vocab = [(piece, score) for piece, score, _ in proto.pieces]
    # T5 appends <extra_id_99>..<extra_id_0> sentinels after the spm vocab
    vocab += [(f"<extra_id_{i}>", 0.0) for i in range(T5_EXTRA_IDS - 1, -1, -1)]
    tok = Tokenizer(Unigram(vocab, unk_id=proto.unk_id, byte_fallback=False))

    # control / user-defined pieces become added tokens (control ones special)
    tok.add_tokens([AddedToken(piece, normalized=False, special=kind == _CONTROL)
                    for piece, _, kind in proto.pieces if kind in (_CONTROL, _USER_DEFINED)])
    tok.add_tokens([AddedToken(f"<extra_id_{i}>", normalized=False, special=True)
                    for i in range(T5_EXTRA_IDS - 1, -1, -1)])

    norms = [normalizers.Strip(left=False, right=True),
             normalizers.Replace(Regex(" {2,}"), "▁")]
    if proto.precompiled_charsmap:
        norms = [normalizers.Precompiled(proto.precompiled_charsmap)] + norms
    tok.normalizer = normalizers.Sequence(norms)
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")

    eos_id = next((i for i, (piece, _, _) in enumerate(proto.pieces) if piece == "</s>"), 1)
    tok.post_processor = TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
        special_tokens=[("</s>", eos_id)])
    return tok


class T5Tokenizer:
    """text(s) -> (B, max_length) int64 ids, ``</s>``-terminated, padded with
    ``<pad>`` and truncated to ``max_length``."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        if os.path.isdir(path):
            json_path = os.path.join(path, "tokenizer.json")
            spiece_path = os.path.join(path, "spiece.model")
            if os.path.isfile(json_path):
                self._tok = Tokenizer.from_file(json_path)
            elif os.path.isfile(spiece_path):
                self._tok = _tokenizer_from_spiece(spiece_path)
            else:
                raise FileNotFoundError(
                    f"no tokenizer.json or spiece.model under {path} -- download the "
                    "CogVideoX-Fun tokenizer/ folder with the text encoder")
        elif path.endswith(".json"):
            self._tok = Tokenizer.from_file(path)
        else:
            self._tok = _tokenizer_from_spiece(path)
        self.pad_id = self._tok.token_to_id("<pad>") or 0
        self.eos_id = self._tok.token_to_id("</s>")

    def __call__(self, text: Union[str, Sequence[str]],
                 max_length: int = T5_MAX_LENGTH) -> torch.Tensor:
        texts: List[str] = [text] if isinstance(text, str) else list(text)
        self._tok.enable_truncation(max_length)
        self._tok.enable_padding(length=max_length, pad_id=self.pad_id, pad_token="<pad>")
        return torch.tensor([e.ids for e in self._tok.encode_batch(texts)], dtype=torch.long)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids])
