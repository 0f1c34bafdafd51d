"""The port's BLIP-2 captioner (trajectorycrafter_tpu_torch/models/blip2.py,
utils/caption.py) vs the JAX package's, at tests/test_blip2.py's ``TINY``
config.

One seeded state dict under transformers' ``Blip2ForConditionalGeneration``
names (the tied ``language_model.lm_head.weight`` included) goes to JAX
through ``convert_blip2`` and to the port through
``load_state_dict(strict=True)`` (the lm head aside).  In fp32 the vision
features, the Q-Former output, the prefix embeddings and the logits agree
to 1e-4 absolute and relative (the same fp32 arithmetic in another
summation order; readings ~1e-6 on values of order 1), and the greedy ids
are equal, with and without an eos that ends the caption early.

``build_captioner`` on a checkpoint directory (safetensors, config.json,
vocab.json, merges.txt, generation_config.json) gives the same string in
both packages, both in bf16 (the weights are bf16 values, so both sides
hold the same numbers).  ``preprocess_frame``'s antialiased bicubic resize
agrees with ``jax.image.resize`` to 1e-5 at 576x1024, and to 5e-5 with one
side upsampled.
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from safetensors.torch import save_file
from test_blip2 import TINY
from torch_parity import fill_from_numpy_

from trajectorycrafter_tpu.models import blip2 as jax_blip2
from trajectorycrafter_tpu.utils.caption import build_captioner as jax_build_captioner
from trajectorycrafter_tpu.utils.convert import RecordingDict, convert_blip2
from trajectorycrafter_tpu_torch.models import blip2
from trajectorycrafter_tpu_torch.utils.bpe import bytes_to_unicode
from trajectorycrafter_tpu_torch.utils.caption import build_captioner

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
CFG = blip2.Blip2Config(**dataclasses.asdict(TINY))
LM_HEAD = "language_model.lm_head.weight"


def _hf_state_dict(bf16_values=False):
    """Seeded weights under the HF names, with the tied lm head."""
    model = fill_from_numpy_(blip2.Blip2Captioner(CFG), 0)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if bf16_values:
        sd = {k: v.bfloat16().float() for k, v in sd.items()}
    sd[LM_HEAD] = sd["language_model.model.decoder.embed_tokens.weight"].clone()
    return sd


@pytest.fixture(scope="module")
def pair():
    sd = _hf_state_dict()
    rec = RecordingDict({k: v.numpy() for k, v in sd.items()})
    params = convert_blip2(rec, vision_layers=CFG.vision_layers, qformer_layers=CFG.qformer_layers,
                           opt_layers=CFG.opt_layers,
                           cross_attention_frequency=CFG.cross_attention_frequency)
    assert rec.consumed == set(sd)
    model = blip2.Blip2Captioner(CFG).eval()
    model.load_state_dict({k: v for k, v in sd.items() if k != LM_HEAD}, strict=True)
    return jax_blip2.Blip2Captioner(TINY), params, model


def _pixels(b=2, seed=1):
    px = np.random.default_rng(seed).standard_normal((b, 3, CFG.image_size, CFG.image_size))
    return px.astype(np.float32)


def test_vision_qformer_prefix_and_logits_match_jax(pair):
    jmodel, params, model = pair
    px = _pixels()
    nhwc = jnp.asarray(px.transpose(0, 2, 3, 1))
    with torch.no_grad():
        vision = model.vision_model(torch.from_numpy(px)).numpy()
        query = model.query_output(torch.from_numpy(px)).numpy()
        prefix = model.prefix_embeds(torch.from_numpy(px))
        logits = model.decode_step(prefix, prefix.shape[1]).numpy()
        part = model.decode_step(prefix, 3).numpy()
    apply = lambda method, *args: np.asarray(jmodel.apply({"params": params}, *args,
                                                          method=method))
    np.testing.assert_allclose(vision, apply(lambda m, p: m.vision_model(p), nhwc), **TOL)
    np.testing.assert_allclose(query, apply(lambda m, p: m.qformer(m.vision_model(p)), nhwc),
                               **TOL)
    want_prefix = apply(jax_blip2.Blip2Captioner.prefix_embeds, nhwc)
    assert prefix.shape == (2, CFG.num_query_tokens + 1, CFG.opt_hidden)
    np.testing.assert_allclose(prefix.numpy(), want_prefix, **TOL)
    want = apply(jax_blip2.Blip2Captioner.decode_step, jnp.asarray(prefix.numpy()),
                 prefix.shape[1])
    assert logits.shape == (2, CFG.num_query_tokens + 1, CFG.vocab_size)
    np.testing.assert_allclose(logits, want, **TOL)
    # slots at and past valid_len are masked out of every attention
    want = apply(jax_blip2.Blip2Captioner.decode_step, jnp.asarray(prefix.numpy()), 3)
    np.testing.assert_allclose(part[:, :3], want[:, :3], **TOL)


@pytest.mark.parametrize("stop", [False, True], ids=["fixed_length", "eos"])
def test_greedy_ids_equal_the_jax_ones(pair, stop):
    jmodel, params, model = pair
    px = _pixels(b=2, seed=2)
    n = 8
    want = np.asarray(jax_blip2.generate_caption_ids(
        jmodel, params, jnp.asarray(px.transpose(0, 2, 3, 1)), max_new_tokens=n,
        eos_token_id=-1))
    eos = -1
    if stop:  # the third token of the first row ends that row's caption
        eos = int(want[0, 2])
        want = np.asarray(jax_blip2.generate_caption_ids(
            jmodel, params, jnp.asarray(px.transpose(0, 2, 3, 1)), max_new_tokens=n,
            eos_token_id=eos))
        assert (want[0, 2:] == eos).all()
    got = blip2.generate_caption_ids(model, torch.from_numpy(px), max_new_tokens=n,
                                     eos_token_id=eos)
    assert got.shape == (2, n)
    np.testing.assert_array_equal(got.numpy(), want)


def _checkpoint_dir(path):
    sd = _hf_state_dict(bf16_values=True)
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path / "model.safetensors"))
    hf = {
        "vision_config": dict(hidden_size=CFG.vision_hidden,
                              intermediate_size=CFG.vision_intermediate,
                              num_hidden_layers=CFG.vision_layers,
                              num_attention_heads=CFG.vision_heads,
                              image_size=CFG.image_size, patch_size=CFG.patch_size),
        "qformer_config": dict(hidden_size=CFG.qformer_hidden,
                               num_hidden_layers=CFG.qformer_layers,
                               num_attention_heads=CFG.qformer_heads,
                               intermediate_size=CFG.qformer_intermediate,
                               cross_attention_frequency=CFG.cross_attention_frequency),
        "text_config": dict(vocab_size=CFG.vocab_size, hidden_size=CFG.opt_hidden,
                            num_hidden_layers=CFG.opt_layers, num_attention_heads=CFG.opt_heads,
                            ffn_dim=CFG.opt_ffn, max_position_embeddings=CFG.max_positions,
                            bos_token_id=CFG.bos_token_id),
        "num_query_tokens": CFG.num_query_tokens,
    }
    (path / "config.json").write_text(json.dumps(hf))
    vocab = {t: i for i, t in enumerate(bytes_to_unicode().values())}
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")


@pytest.mark.parametrize("generation", [
    {"eos_token_id": 7, "max_length": 6}, {"eos_token_id": 7, "max_length": 6,
                                            "max_new_tokens": 3}, {}],
    ids=["max_length", "max_new_tokens", "defaults"])
def test_build_captioner_gives_the_jax_caption(tmp_path, generation):
    _checkpoint_dir(tmp_path)
    (tmp_path / "generation_config.json").write_text(json.dumps(generation))
    frame = np.random.default_rng(3).uniform(0, 1, (30, 40, 3)).astype(np.float32)
    caption = build_captioner(str(tmp_path), device="cpu")
    got = caption(frame)
    assert caption.model.decoder.embed_tokens.weight.dtype == torch.bfloat16
    assert caption.max_new == generation.get("max_new_tokens", 5 if generation else 19)
    assert caption.last_ids.shape == (caption.max_new,)
    assert got == caption.tokenizer.decode(caption.last_ids.tolist()).strip()
    assert got == jax_build_captioner(str(tmp_path))(frame)


def test_build_captioner_falls_back_only_when_the_dir_is_missing(tmp_path, capsys):
    missing = build_captioner(str(tmp_path / "missing"), device="cpu")
    assert missing(None) == "a video" and "using the fixed prompt" in capsys.readouterr().out
    (tmp_path / "broken").mkdir()  # exists, holds no checkpoint: raises, no fallback
    with pytest.raises(FileNotFoundError):
        build_captioner(str(tmp_path / "broken"), device="cpu")


@pytest.mark.parametrize("shape,atol", [((576, 1024, 3), 1e-5), ((160, 1024, 3), 5e-5)],
                         ids=["576x1024", "upsampled"])
def test_preprocess_frame_matches_jax(shape, atol):
    """Upsampling one side, each fp32 resize sits ~1e-5 from the fp64 one
    (before the division by the CLIP std, ~0.27), so the bound is looser there."""
    frame = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax_blip2.preprocess_frame(frame))
    got = blip2.preprocess_frame(frame)
    assert got.shape == (1, 3, 224, 224)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=atol, rtol=0)
