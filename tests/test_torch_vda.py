"""Video-Depth-Anything (trajectorycrafter_tpu_torch/models/vda.py), its weight
bridge and its loader vs the JAX package.

* ``resize_bicubic_jax`` against ``jax.image.resize(..., "bicubic")`` (the
  position table's resize) at the deployed grids, 1e-5 of the magnitude.
* The whole model (hidden 32, 2 layers, 4 motion modules, features 16) with
  seeded weights carried JAX tree -> ``vda_from_jax`` -> the port, at the
  table's own grid and at a grid that shrinks one axis and grows the other;
  the motion module at 40 frames (above the official 32-frame table); the
  windowed ``infer_video_depth`` over 40 frames (two windows of 32); the
  model with its attention cut into several chunks of streams: each within
  1e-5 of the output's largest magnitude.
* The key manifest equals ``expected_vda_official_keys``;
  ``convert_vda_official(vda_from_jax(p))`` is ``p`` leaf for leaf;
  ``load_vda`` loads a ``.pth`` (and a ``.safetensors``) the test writes and
  refuses a missing key, an extra key and a wrong ``pos_encoder.pe``.
* The recomputation (``model.checkpoint``) changes no value: outputs and
  input gradients equal without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import fill_from_numpy_

from trajectorycrafter_tpu.models import vda as jax_vda
from trajectorycrafter_tpu.utils import convert
from trajectorycrafter_tpu_torch.models import vda
from trajectorycrafter_tpu_torch.ops.resize import resize_bicubic_jax
from trajectorycrafter_tpu_torch.utils import checkpoints
from trajectorycrafter_tpu_torch.utils.weights import vda_from_jax

torch.set_num_threads(1)
REL_TOL = 1e-5
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, patch_size=14,
            image_size=56, out_indices=(1, 2, 2, 2), features=16, out_channels=(8, 8, 16, 16),
            head_hidden_size=8, num_temporal_blocks=4, temporal_heads=4)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def tiny_pair(seed: int = 0, **kw):
    """(JAX model, its params, the port's model) on one set of seeded weights:
    the port's module filled from numpy, converted to the JAX tree by the JAX
    converter, and the tree carried back into a fresh port module through
    ``vda_from_jax``.  The head's last bias is 0.5 so its ReLU is alive."""
    cfg = dict(TINY, **kw)
    src = fill_from_numpy_(vda.VideoDepthAnything(vda.VDAConfig(**cfg)), seed)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    params = convert.convert_vda_official(sd, num_layers=cfg["num_hidden_layers"],
                                          num_temporal_blocks=cfg["num_temporal_blocks"])
    params["head"]["head_conv3"]["bias"] = np.full((1,), 0.5, np.float32)
    port = vda.VideoDepthAnything(vda.VDAConfig(**cfg))
    port.load_state_dict(checkpoints.vda_module_state_dict(vda_from_jax(params), port.cfg),
                         strict=True)
    return jax_vda.VideoDepthAnything(jax_vda.VDAConfig(**cfg)), params, port.eval()


@pytest.mark.parametrize("grid,out", [(37, (20, 36)), (37, (42, 74)), (4, (2, 5)),
                                      (4, (6, 3)), (5, (5, 8))])
def test_resize_bicubic_matches_jax_image_resize(grid, out):
    x = np.random.default_rng(1).standard_normal((grid, grid, 24)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (*out, 24), "bicubic"))
    got = resize_bicubic_jax(torch.from_numpy(x).permute(2, 0, 1), out).permute(1, 2, 0)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= REL_TOL


@pytest.mark.parametrize("hw", [(56, 56), (28, 70)], ids=["table_grid", "shrink_h_grow_w"])
def test_vda_matches_jax(hw):
    jm, params, port = tiny_pair()
    frames = np.random.default_rng(2).standard_normal((1, 3, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(frames)))
    with torch.no_grad():
        got = port(torch.from_numpy(frames).permute(0, 1, 4, 2, 3)).numpy()
    assert got.shape == want.shape == (1, 3, *hw)
    assert np.abs(want).max() > 0.1
    assert _rel(got, want) <= REL_TOL


def test_vda_matches_jax_with_chunked_attention(monkeypatch):
    """Scores budgeted to three backbone streams a chunk: the backbone's
    attention (12 streams of 17 tokens) and the motion modules' (streams of 3
    frames, one for each pixel and head) each run in several chunks, and the
    model still agrees with JAX."""
    jm, params, port = tiny_pair()
    frames = np.random.default_rng(2).standard_normal((1, 3, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(frames)))
    monkeypatch.setattr(vda, "ATTENTION_CHUNK_BYTES", 3 * 17 * 17 * 4)
    chunks = {}  # tokens a stream -> most chunks one call took
    plain = vda.attention

    def counted(q, k, v):
        n, s, _ = q.shape
        step = max(1, vda.ATTENTION_CHUNK_BYTES // (s * k.shape[1] * 4))
        chunks[s] = max(chunks.get(s, 0), -(-n // step))
        return plain(q, k, v)

    monkeypatch.setattr(vda, "attention", counted)
    with torch.no_grad():
        got = port(torch.from_numpy(frames).permute(0, 1, 4, 2, 3)).numpy()
    assert chunks[17] == 4 and chunks[3] > 1
    assert _rel(got, want) <= REL_TOL


def test_temporal_module_matches_jax_above_the_official_table():
    """The motion module over 40 frames: the frame table is computed for any
    length (the official buffer holds 32)."""
    _, params, port = tiny_pair(seed=3)
    t, c = 40, 16
    x = np.random.default_rng(4).standard_normal((1, t, 3, 5, c)).astype(np.float32)
    tm = params["head"]["temporal_2"]
    want = np.asarray(jax.jit(jax_vda.TemporalModule(c, 4).apply)({"params": tm},
                                                                 jnp.asarray(x)))
    with torch.no_grad():
        got = port.head.motion_modules[2](
            torch.from_numpy(x[0]).permute(0, 3, 1, 2), t).permute(0, 2, 3, 1).numpy()[None]
    assert _rel(got, want) <= REL_TOL
    table = vda.sinusoidal_frame_encoding(49, 1024).numpy()
    np.testing.assert_allclose(table, np.asarray(jax_vda.sinusoidal_frame_encoding(49, 1024)),
                               rtol=0, atol=4e-6)


def test_infer_video_depth_matches_jax_over_two_windows():
    jm, params, port = tiny_pair(seed=5)
    frames = np.random.default_rng(6).standard_normal((40, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jax_vda.infer_video_depth(jm, params, jnp.asarray(frames)))
    got = vda.infer_video_depth(port, torch.from_numpy(frames).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (40, 28, 28)
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("layers,factors,temporal", [
    (24, (4.0, 2.0, 1.0, 0.5), 4), (12, (4.0, 2.0, 1.0, 0.5), 4), (2, (4.0, 2.0, 1.0, 0.5), 0),
    (3, (2.0, 1.0, 1.0, 0.5), 2)])
def test_key_manifest_is_the_jax_manifest(layers, factors, temporal):
    got = checkpoints.expected_vda_official_keys(layers, factors, temporal)
    assert got == convert.expected_vda_official_keys(layers, factors, temporal)


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl"])
def test_module_keys_are_the_manifest_without_the_dropped_ones(encoder):
    """The preset's module holds every manifest key but ``mask_token`` and the
    ``pos_encoder.pe`` buffers; the presets are the JAX package's."""
    cfg = vda.vda_config(encoder)
    jcfg = getattr(jax_vda, f"vda_{encoder}_config")()
    assert vars(cfg) == vars(jcfg)
    with torch.device("meta"):
        model = vda.VideoDepthAnything(cfg)
    manifest = checkpoints.expected_vda_official_keys(cfg.num_hidden_layers)
    dropped = {k for k in manifest if k == "pretrained.mask_token" or k.endswith(".pe")}
    assert len(dropped) == 1 + 8
    assert set(model.state_dict()) == manifest - dropped


@pytest.mark.parametrize("temporal", [4, 0])
def test_vda_from_jax_round_trips_through_the_converter(temporal):
    _, params, _ = tiny_pair(seed=7, num_temporal_blocks=temporal)
    sd = vda_from_jax(params)
    assert set(sd) == convert.expected_vda_official_keys(2, num_temporal_blocks=temporal)
    back = convert.convert_vda_official({k: v.numpy() for k, v in sd.items()}, num_layers=2,
                                        num_temporal_blocks=temporal)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fmt", [".pth", ".safetensors"])
def test_load_vda_reads_the_official_file(tmp_path, fmt):
    _, params, port = tiny_pair(seed=8)
    path = str(tmp_path / f"vda{fmt}")
    sd = checkpoints.vda_official_state_dict(port.state_dict())
    assert set(sd) == checkpoints.expected_vda_official_keys(2)
    if fmt == ".pth":
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    loaded = checkpoints.load_vda(path, device="cpu", cfg=port.cfg)
    for key, t in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[key], t, rtol=0, atol=0)


@pytest.mark.parametrize("damage", ["missing", "extra", "wrong_pe", "wrong_encoder"])
def test_load_vda_refuses_a_damaged_file(tmp_path, damage):
    _, _, port = tiny_pair(seed=9)
    sd = checkpoints.vda_official_state_dict(port.state_dict())
    pe_key = next(k for k in sd if k.endswith("attention_blocks.1.pos_encoder.pe"))
    kw = {"cfg": port.cfg}
    if damage == "missing":
        del sd["pretrained.blocks.1.ls2.gamma"]
    elif damage == "extra":
        sd["head.scratch.output_conv3.weight"] = torch.zeros(1)
    elif damage == "wrong_pe":
        sd[pe_key] = sd[pe_key].flip(1)  # the table of the frames in reverse
    else:
        kw = {"encoder": "vits"}
    path = str(tmp_path / "vda.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="vda_official"):
        checkpoints.load_vda(path, device="cpu", **kw)


def test_recompute_changes_no_value():
    _, _, port = tiny_pair(seed=10)
    port.requires_grad_(False)
    frames = torch.from_numpy(
        np.random.default_rng(11).standard_normal((1, 3, 3, 28, 42)).astype(np.float32))
    outs = []
    for on in (False, True):
        x = frames.clone().requires_grad_(True)
        port.checkpoint = on
        out = port(x)
        (out**2).sum().backward()
        outs.append((out.detach(), x.grad))
    port.checkpoint = False
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


def test_imagenet_normalisation_matches_jax():
    x = np.random.default_rng(12).random((2, 4, 5, 3), dtype=np.float32)
    want = np.asarray(jax_vda.normalize_imagenet(jnp.asarray(x)))
    got = vda.normalize_imagenet(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = vda.denormalize_imagenet(vda.normalize_imagenet(torch.from_numpy(x)
                                                           .permute(0, 3, 1, 2)))
    np.testing.assert_allclose(back.permute(0, 2, 3, 1).numpy(), x, atol=1e-6)
