"""The port's GPT-2 byte-level BPE (trajectorycrafter_tpu_torch/utils/bpe.py) vs
the JAX package's (trajectorycrafter_tpu/utils/bpe.py): the same byte map,
and equal encodes and decodes over the synthetic vocabulary and merges of
tests/test_bpe.py, built directly and through ``from_dir``."""

import json

import numpy as np
import pytest
from test_bpe import MERGES, _vocab

from trajectorycrafter_tpu.utils import bpe as jax_bpe
from trajectorycrafter_tpu_torch.utils import bpe

TEXTS = ("hello world", "a 123 or llo", "héllo world", "why, hello...", "snake_case or_ _12",
         "a__b", "_", "  spaced  out ", "", "tab\there\nnewline", "emoji 🙂 and 中文",
         "it's they're we've I'm you'll he'd")


def test_byte_map_is_the_jax_one():
    assert bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()
    assert len(set(bpe.bytes_to_unicode().values())) == 256


@pytest.mark.parametrize("special", [False, True], ids=["plain", "special_tokens"])
def test_encode_and_decode_equal_the_jax_tokenizer(special):
    specials = {"</s>": _vocab()["</s>"]} if special else None
    port = bpe.GPT2BPETokenizer(_vocab(), MERGES, special_tokens=specials)
    ref = jax_bpe.GPT2BPETokenizer(_vocab(), MERGES, special_tokens=specials)
    for text in TEXTS:
        ids = port.encode(text)
        assert ids == ref.encode(text), text
        assert port.decode(ids) == ref.decode(ids) == text
    ids = [_vocab()["</s>"]] + port.encode("hello") + [_vocab()["</s>"], 10 ** 6]
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)
    # random ids, as a caption decode sees them
    rng = np.random.default_rng(0)
    ids = rng.integers(0, len(_vocab()) + 5, 200).tolist()
    assert port.decode(ids) == ref.decode(ids)


def test_from_dir_equals_the_jax_tokenizer(tmp_path):
    (tmp_path / "vocab.json").write_text(json.dumps(_vocab()))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n")
    (tmp_path / "special_tokens_map.json").write_text(
        json.dumps({"bos_token": "</s>", "eos_token": {"content": "</s>"},
                    "unk_token": "<|endoftext|>", "pad_token": "<pad>"}))
    port = bpe.GPT2BPETokenizer.from_dir(str(tmp_path))
    ref = jax_bpe.GPT2BPETokenizer.from_dir(str(tmp_path))
    assert port.special == ref.special and port.bpe_ranks == ref.bpe_ranks
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))


def test_chip_smoke_bpe_files_have_opts_size(tmp_path):
    """chip_smoke.py's byte-level vocabulary: OPT's 50,265 entries, read the
    same way by both packages."""
    from test_torch_tokenizer import _chip_smoke

    _chip_smoke().write_bpe_files(tmp_path)
    port = bpe.GPT2BPETokenizer.from_dir(str(tmp_path))
    ref = jax_bpe.GPT2BPETokenizer.from_dir(str(tmp_path))
    assert len(port.encoder) == 50265 and port.special == ref.special
    ids = np.random.default_rng(1).integers(0, 50272, 64).tolist()
    assert port.decode(ids) == ref.decode(ids) and port.decode(ids).strip()
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
        assert port.decode(port.encode(text)) == text
