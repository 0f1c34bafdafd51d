"""The port's T5 tokenizer (trajectorycrafter_tpu_torch/utils/tokenizer.py) vs
the JAX package's (trajectorycrafter_tpu/utils/tokenizer.py).

Both read the synthetic Unigram ``spiece.model`` of tests/test_tokenizer.py
(and its ``tokenizer.json`` form); the ids must be equal, exactly: several
prompts, truncation, padding, runs of spaces, characters outside the
vocabulary.  The port parses ``spiece.model`` from the protobuf wire format
itself: its pieces, scores, types, ``unk_id``, model type and charsmap must
be those of transformers' protobuf parse, on the synthetic model and on a
large random one (multi-byte varints, negative scores, every piece type).
"""

import numpy as np
import pytest
import torch
from test_tokenizer import _synth_spiece

from trajectorycrafter_tpu.utils.tokenizer import T5Tokenizer as JaxT5Tokenizer
from trajectorycrafter_tpu_torch.orchestrator import T5PromptEncoder
from trajectorycrafter_tpu_torch.utils.tokenizer import T5Tokenizer, read_spiece

PROMPTS = ["hello world", "helloworld", "a", "", "hello  world  ", "   hello",
           "zzz hello qq world!", "héllo wörld", "a b c d e f g h i j k l", "hello\tworld\nhello"]


def _pb2_fields(data: bytes):
    from transformers.utils import sentencepiece_model_pb2_new as model_pb2

    m = model_pb2.ModelProto()
    m.ParseFromString(data)
    return ([(p.piece, p.score, p.type) for p in m.pieces], m.trainer_spec.model_type,
            m.trainer_spec.unk_id, m.normalizer_spec.precompiled_charsmap)


def _port_fields(data: bytes):
    m = read_spiece(data)
    return m.pieces, m.model_type, m.unk_id, m.precompiled_charsmap


@pytest.mark.parametrize("max_length", [4, 8, 226])
def test_ids_equal_the_jax_tokenizer(tmp_path, max_length):
    path, _ = _synth_spiece(tmp_path)
    port, jax_tok = T5Tokenizer(path), JaxT5Tokenizer(path)
    assert (port.pad_id, port.eos_id) == (jax_tok.pad_id, jax_tok.eos_id) == (0, 1)
    got = port(PROMPTS, max_length=max_length)
    want = jax_tok(PROMPTS, max_length=max_length)
    assert got.dtype == torch.long and got.shape == (len(PROMPTS), max_length)
    np.testing.assert_array_equal(got.numpy(), want)
    for text in PROMPTS:  # one at a time, as the prompt encode calls it
        np.testing.assert_array_equal(port(text, max_length).numpy(), jax_tok(text, max_length))
    assert port.decode(got[0].tolist()) == jax_tok.decode(want[0])


def test_tokenizer_json_and_dir_routes_equal_the_jax_ones(tmp_path):
    path, _ = _synth_spiece(tmp_path)
    JaxT5Tokenizer(path)._tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "spiece.model").rename(tmp_path / "unused.model")
    for source in (str(tmp_path), str(tmp_path / "tokenizer.json")):  # the dir reads tokenizer.json
        np.testing.assert_array_equal(T5Tokenizer(source)(PROMPTS, 16).numpy(),
                                      JaxT5Tokenizer(source)(PROMPTS, 16))


def test_missing_tokenizer_dir_is_actionable(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json or spiece.model"):
        T5Tokenizer(str(tmp_path))


def test_wire_reader_equals_the_protobuf_parse(tmp_path):
    path, _ = _synth_spiece(tmp_path)
    data = open(path, "rb").read()
    assert _port_fields(data) == _pb2_fields(data)

    from transformers.utils import sentencepiece_model_pb2_new as model_pb2

    rng = np.random.default_rng(0)
    m = model_pb2.ModelProto()
    for i in range(3000):
        p = m.pieces.add()
        p.piece = "▁" * (i % 2) + "".join(chr(c) for c in rng.integers(0x61, 0x3000, 1 + i % 5))
        p.score = float(np.float32(-rng.exponential(5.0)))
        if i % 7:  # an unset type is NORMAL (1)
            p.type = int(rng.integers(1, 7))
    m.trainer_spec.model_type = 1
    m.trainer_spec.unk_id = 2
    m.trainer_spec.vocab_size = 3000  # fields the reader skips
    m.trainer_spec.input.append("corpus.txt")
    m.normalizer_spec.name = "nmt_nfkc"
    m.normalizer_spec.precompiled_charsmap = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    m.normalizer_spec.add_dummy_prefix = True
    data = m.SerializeToString()
    got = _port_fields(data)
    assert got == _pb2_fields(data)
    assert len(got[0]) == 3000 and len(got[3]) == 5000


def test_a_bpe_sentencepiece_model_is_refused_by_both(tmp_path):
    from transformers.utils import sentencepiece_model_pb2_new as model_pb2

    path, _ = _synth_spiece(tmp_path)
    m = model_pb2.ModelProto()
    m.ParseFromString(open(path, "rb").read())
    m.trainer_spec.model_type = 2  # BPE
    bpe = tmp_path / "bpe.model"
    bpe.write_bytes(m.SerializeToString())
    for tokenizer in (T5Tokenizer, JaxT5Tokenizer):
        with pytest.raises(ValueError, match="not a Unigram"):
            tokenizer(str(bpe))


def test_prompt_encoder_feeds_t5_the_tokenizer_ids(tmp_path):
    from trajectorycrafter_tpu_torch.models.t5 import T5EncoderModel

    path, _ = _synth_spiece(tmp_path)
    t5 = T5EncoderModel(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=1,
                        num_heads=4).eval()
    seen = []
    t5.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    encode = T5PromptEncoder(t5, 12, T5Tokenizer(path))
    pe, ne = encode("hello world", None)
    assert pe.shape == ne.shape == (1, 12, 16)
    np.testing.assert_array_equal(seen[0].numpy(),
                                  JaxT5Tokenizer(path)(["hello world", ""], max_length=12))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_spiece_model_is_a_t5_unigram_model(tmp_path):
    """The 32,000-piece ``spiece.model`` chip_smoke.py writes for its
    checkpoint tree: protobuf parses it as the port's reader does, and both
    tokenizers give equal ids within T5's 32,128-row embedding."""
    data = _chip_smoke().spiece_model_bytes()
    fields = _port_fields(data)
    assert fields == _pb2_fields(data)
    assert len(fields[0]) == 32000 and fields[1:3] == (1, 2)
    (tmp_path / "spiece.model").write_bytes(data)
    port, jax_tok = T5Tokenizer(str(tmp_path)), JaxT5Tokenizer(str(tmp_path))
    assert port._tok.get_vocab_size() == 32100
    texts = PROMPTS + ["The video is not of a high quality, it has a low resolution."]
    ids = port(texts, 226)
    np.testing.assert_array_equal(ids.numpy(), jax_tok(texts, 226))
    assert int(ids.max()) < 32128 and (ids[:, 0] != 2).any()
