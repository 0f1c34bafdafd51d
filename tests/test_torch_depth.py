"""The port's depth stage vs the JAX package: Euler, resize, CLIP, SVD VAE,
the SVD UNet, the windowed DepthCrafter pipeline, and the slice with it.

Weights are seeded numpy draws into a port module, turned into the JAX tree
by the JAX package's converters and loaded back through the port's
``*_from_jax`` (tests/torch_parity.py); each tree is also checked against
the flax model's own parameter paths and shapes.  Tiny widths of
tests/test_reference_depth_parity.py (``UNET_TINY``, ``VAE_TINY``), fp32.

Tolerances, each against outputs of order 1:
  * Euler tables: 1e-6 relative (both build them in float64 numpy and
    store float32); Euler steps: 1e-5 relative plus 2^-21 of the first
    sigma (the samples start at |x| ~ sigma_max = 700, where an fp32 ulp is
    ~6e-5, and the two sides round the step's coefficients differently);
  * resize: 1e-5 absolute on [0, 1] pixels (the same half-pixel
    coordinates; fp32 weights rounded at other points read ~2e-6, while a
    wrong pixel-centre convention reads ~1e-2);
  * CLIP, VAE, UNet: 1e-4 absolute and relative (fp32 summation order
    through a few dozen layers; the readings are ~1e-5), the UNet also
    under ``TRAJCRAFTER_DEPTH_ATTN=xla`` on both sides;
  * the pipeline's disparity: 2e-4 absolute (two Euler steps from sigma
    700 multiply the UNet's rounding by ~10; the reading is ~6e-5).
"""

from pathlib import Path
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import fill_from_numpy_, jax_tree

from trajectorycrafter_tpu_torch.cli import config_from_args, get_parser
from trajectorycrafter_tpu.models.clip import CLIPVisionConfig
from trajectorycrafter_tpu.models.clip import CLIPVisionModelWithProjection as JaxCLIP
from trajectorycrafter_tpu.models.depthcrafter import UNetSpatioTemporalConditionModel as JaxUNet
from trajectorycrafter_tpu.models.svd_vae import AutoencoderKLTemporalDecoder as JaxSVDVAE
from trajectorycrafter_tpu.models.svd_vae import svd_decode_chunked as jax_decode_chunked
from trajectorycrafter_tpu.models.svd_vae import svd_encode_chunked as jax_encode_chunked
from trajectorycrafter_tpu.ops.resize import resize_linear as jax_resize_linear
from trajectorycrafter_tpu.pipelines.depth import DepthCrafterPipeline as JaxDepthPipeline
from trajectorycrafter_tpu.pipelines.depth import svd_euler_scheduler as jax_svd_euler
from trajectorycrafter_tpu.schedulers.euler import EulerDiscreteScheduler as JaxEuler
from trajectorycrafter_tpu.utils.convert import (
    convert_clip_vision,
    convert_svd_unet,
    convert_svd_vae,
)
from trajectorycrafter_tpu_torch.models.clip import CLIPVisionModelWithProjection
from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
from trajectorycrafter_tpu_torch.models.svd_vae import (
    AutoencoderKLTemporalDecoder,
    svd_decode_chunked,
    svd_encode_chunked,
)
from trajectorycrafter_tpu_torch.models.t5 import T5EncoderModel
from trajectorycrafter_tpu_torch.ops.resize import resize_linear
from trajectorycrafter_tpu_torch.orchestrator import (
    TrajCrafter,
    build_dev_models,
    check_supported,
    depth_stage,
    T5PromptEncoder,
)
from trajectorycrafter_tpu_torch.pipelines.depth import (
    DepthCrafterPipeline,
    chain_blend,
    svd_euler_scheduler,
    window_starts,
)
from trajectorycrafter_tpu_torch.schedulers.euler import EulerDiscreteScheduler
from trajectorycrafter_tpu_torch.utils.weights import (
    clip_from_jax,
    svd_unet_from_jax,
    svd_vae_from_jax,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
REPO = Path(__file__).resolve().parents[1]
UNET_TINY = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                 num_attention_heads=(2, 2, 2, 2), cross_attention_dim=12, norm_num_groups=4)
VAE_TINY = dict(block_out_channels=(32, 32, 64, 64))
CLIP_TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, image_size=28, patch_size=14, projection_dim=16)


def _assert_same_structure(tree, shapes):
    """``tree`` has exactly the flax model's parameter paths and shapes."""
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(tree) == flat(shapes)


@pytest.fixture(scope="module")
def unets():
    params = jax_tree(UNetSpatioTemporalConditionModel(**UNET_TINY), 0, convert_svd_unet,
                      layers_per_block=1)
    junet = JaxUNet(**UNET_TINY)
    _assert_same_structure(params, jax.eval_shape(
        junet.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, 2, 1, 12)), jnp.zeros((1, 3)))["params"])
    unet = UNetSpatioTemporalConditionModel(**UNET_TINY)
    unet.load_state_dict(svd_unet_from_jax(params), strict=True)
    return (junet, params), unet.eval()


@pytest.fixture(scope="module")
def vaes():
    params = jax_tree(AutoencoderKLTemporalDecoder(**VAE_TINY), 1, convert_svd_vae)
    jvae = JaxSVDVAE(**VAE_TINY)
    _assert_same_structure(params, jax.eval_shape(
        jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))["params"])
    vae = AutoencoderKLTemporalDecoder(**VAE_TINY)
    vae.load_state_dict(svd_vae_from_jax(params), strict=True)
    return (jvae, params), vae.eval()


@pytest.mark.parametrize("steps", [2, 5, 25])
def test_euler_matches_jax(steps):
    """The SVD configuration (continuous Karras, v-prediction) and the
    default one (discrete, leading): tables, input scaling and two steps."""
    for make_jax, make_port in ((jax_svd_euler, svd_euler_scheduler),
                                (JaxEuler, EulerDiscreteScheduler)):
        jsched, sched = make_jax(), make_port()
        jstate, state = jsched.set_timesteps(steps), sched.set_timesteps(steps)
        np.testing.assert_allclose(state.sigmas, np.asarray(jstate.sigmas), rtol=1e-6)
        np.testing.assert_allclose(state.timesteps, np.asarray(jstate.timesteps), rtol=1e-6)
        assert state.init_noise_sigma == pytest.approx(float(jstate.init_noise_sigma), rel=1e-6)
        rng = np.random.default_rng(steps)
        x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32) * state.init_noise_sigma
        for i in range(2):
            out = rng.standard_normal(x.shape).astype(np.float32)
            want_in = np.asarray(jsched.scale_model_input(jstate, jnp.asarray(x), i))
            got_in = sched.scale_model_input(state, torch.from_numpy(x), i).numpy()
            np.testing.assert_allclose(got_in, want_in, rtol=1e-5, atol=1e-6)
            want = np.asarray(jsched.step(jstate, jnp.asarray(out), i, jnp.asarray(x)))
            x = sched.step(state, torch.from_numpy(out), i, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(x, want, rtol=1e-5,
                                       atol=2.0 ** -21 * state.init_noise_sigma)
    assert svd_euler_scheduler().set_timesteps(5).sigmas[0] == pytest.approx(700.0, rel=1e-6)


@pytest.mark.parametrize("size", [(224, 224), (16, 20), (37, 53), (90, 11)])
def test_resize_linear_is_f_interpolate_and_matches_jax(size):
    """``F.interpolate(bilinear, align_corners=False, antialias=False)`` is
    the JAX package's half-pixel gather, down, up and unchanged."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 37, 53)).astype(np.float32)
    want = np.asarray(jax_resize_linear(jnp.asarray(x), size))
    got = resize_linear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_clip_matches_jax():
    params = jax_tree(CLIPVisionModelWithProjection(**CLIP_TINY), 2, convert_clip_vision,
                      num_layers=2)
    jclip = JaxCLIP(CLIPVisionConfig(**CLIP_TINY))
    _assert_same_structure(params, jax.eval_shape(
        jclip.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))["params"])
    clip = CLIPVisionModelWithProjection(**CLIP_TINY)
    clip.load_state_dict(clip_from_jax(params), strict=True)
    px = np.random.default_rng(1).standard_normal((3, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jclip.apply({"params": params}, jnp.asarray(px)))
    with torch.no_grad():
        got = clip.eval()(torch.from_numpy(px)).numpy()
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_svd_vae_chunked_encode_and_decode_match_jax(vaes):
    """Encode in chunks of 2 frames (5 frames: a short last chunk) and decode
    in chunks of 2 (the last frame decoded at its true length), and the
    deployed decode-chunk rule (4 frames at 576x1024)."""
    (jvae, params), vae = vaes
    rng = np.random.default_rng(3)
    frames = rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_encode_chunked(jvae, params, jnp.asarray(frames), chunk=2))
    got = svd_encode_chunked(vae, torch.from_numpy(frames), chunk=2).numpy()
    assert got.shape == (1, 5, 4, 4, 8)
    np.testing.assert_allclose(got, want, **TOL)

    z = rng.standard_normal((1, 5, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jax_decode_chunked(jvae, params, jnp.asarray(z), chunk=2))
    got = svd_decode_chunked(vae, torch.from_numpy(z), chunk=2).numpy()
    assert got.shape == (1, 5, 32, 32, 3)
    np.testing.assert_allclose(got, want, **TOL)
    # chunking is semantics: the last frame alone equals a one-frame decode
    with torch.no_grad():
        np.testing.assert_array_equal(got[:, 4:], vae.decode(torch.from_numpy(z[:, 4:])).numpy())
    with mock.patch.object(vae, "decode", side_effect=lambda zc: torch.zeros(zc.shape[:2])) as dec:
        svd_decode_chunked(vae, torch.zeros((1, 9, 72, 128, 4)))
    assert [c.args[0].shape[1] for c in dec.call_args_list] == [4, 4, 1]


def test_unet_matches_jax(unets):
    (junet, params), unet = unets
    rng = np.random.default_rng(4)
    b, f, h, w = 2, 3, 8, 8
    sample = rng.standard_normal((b, f, h, w, 8)).astype(np.float32)
    ctx = rng.standard_normal((b, f, 1, 12)).astype(np.float32)
    added = np.array([[6.0, 127.0, 0.02], [3.0, 80.0, 0.1]], np.float32)
    t = np.full((b,), 0.25 * np.log(2.5), np.float32)
    want = np.asarray(jax.jit(junet.apply)({"params": params}, *map(jnp.asarray,
                                                                    (sample, t, ctx, added))))
    with torch.no_grad():
        got = unet(*map(torch.from_numpy, (sample, t, ctx, added))).numpy()
    assert got.shape == (b, f, h, w, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_unet_matches_jax_under_depth_attn_xla(unets, monkeypatch):
    """``TRAJCRAFTER_DEPTH_ATTN=xla``, which the JAX UNet hands on to its
    einsum, runs in the port (the plain version) and matches the JAX UNet
    under the same variable, to ``TOL``."""
    from trajectorycrafter_tpu_torch.models.depthcrafter import DEPTH_ATTN_ENV

    monkeypatch.setenv(DEPTH_ATTN_ENV, "xla")
    (junet, params), unet = unets
    rng = np.random.default_rng(6)
    b, f, h, w = 1, 2, 16, 16
    sample = rng.standard_normal((b, f, h, w, 8)).astype(np.float32)
    ctx = rng.standard_normal((b, f, 1, 12)).astype(np.float32)
    added = np.array([[6.0, 127.0, 0.02]], np.float32)
    t = np.full((b,), 0.25 * np.log(2.5), np.float32)
    want = np.asarray(jax.jit(junet.apply)({"params": params}, *map(jnp.asarray,
                                                                    (sample, t, ctx, added))))
    with torch.no_grad():
        got = unet(*map(torch.from_numpy, (sample, t, ctx, added))).numpy()
    assert got.shape == (b, f, h, w, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_window_starts_and_chain_blend():
    assert window_starts(49, 110, 25) == [0]
    assert window_starts(7, 4, 2) == [0, 2, 3]
    assert window_starts(200, 110, 25) == [0, 85, 90]
    old, new = torch.ones((10, 2, 2, 1)), torch.full((6, 2, 2, 1), 3.0)
    out = chain_blend(old.clone(), new, 4, 3)
    w = np.linspace(0, 1, 3)
    np.testing.assert_allclose(out[4:7, 0, 0, 0].numpy(), 3.0 * w + 1.0 * (1 - w), rtol=1e-6)
    np.testing.assert_array_equal(out[7:].numpy(), 3.0)
    np.testing.assert_array_equal(out[:4].numpy(), 1.0)


@pytest.mark.parametrize("guidance", [1.0, 2.5], ids=["no_cfg", "cfg"])
def test_depth_pipeline_matches_jax(unets, vaes, guidance):
    """Two windows of 4 over 6 frames with an overlap of 2, 2 Euler steps,
    the same per-window noise and CLIP embeddings on both sides; the final
    disparity is compared."""
    (junet, uparams), unet = unets
    (jvae, vparams), vae = vaes
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (6, 64, 64, 3)).astype(np.float32)
    embeds = rng.standard_normal((6, 1, 12)).astype(np.float32)
    noises = [rng.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(2)]
    kw = dict(num_inference_steps=2, guidance_scale=guidance, window_size=4, overlap=2,
              image_embeddings=embeds, window_noises=noises)
    want = JaxDepthPipeline(unet=junet, unet_params=uparams, vae=jvae, vae_params=vparams,
                            dtype=jnp.float32)(frames, **kw)
    got = DepthCrafterPipeline(unet=unet, vae=vae, dtype=torch.float32)(frames, **kw)
    assert got.shape == (6, 64, 64) and got.std() > 0.01
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _cfg(tmp_path, *extra):
    args = get_parser().parse_args([
        "--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
        "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
        "--prompt", "a scene", "--quant", "none", "--diffusion_inference_steps", "2",
        "--video_length", "9", "--sample_size", "32", "48", "--depth_inference_steps", "2",
        "--out_dir", str(tmp_path), "--exp_name", "run", *extra])
    cfg = config_from_args(args)
    cfg.warp_size = (48, 80)  # no CLI flag: a tiny warp for the CPU
    return cfg


def test_infer_gradual_with_depth_and_t5_writes_five_mp4s(tmp_path, unets, vaes):
    """The slice on the CPU with the tiny DepthCrafter stack (UNet, SVD VAE,
    CLIP) in the depth stage and a tiny T5 (the dev DiT's text width 64 and
    length 16) in the prompt encode: the depth it hands the warp is finite,
    within [near, far] and not the plane stand-in."""
    cfg = _cfg(tmp_path)
    cfg.warp_size = (64, 128)  # the SVD UNet takes sides that are multiples of 64
    models = build_dev_models(cfg, "cpu")
    clip = fill_from_numpy_(CLIPVisionModelWithProjection(**{**CLIP_TINY, "projection_dim": 12}), 6)
    depth_infer = depth_stage(unets[1], vaes[1], clip.eval(), torch.float32)
    seen = []
    models.depth_infer = lambda *a, **kw: seen.append(depth_infer(*a, **kw)) or seen[-1]
    t5 = fill_from_numpy_(T5EncoderModel(vocab_size=100, d_model=64, d_kv=8, d_ff=128,
                                         num_layers=2, num_heads=8), 7)
    models.encode_prompt = T5PromptEncoder(t5.eval(), 16)
    tc = TrajCrafter(cfg, models=models)
    gen = tc.infer_gradual()
    assert gen.shape == (9, 32, 48, 3) and np.isfinite(gen).all()
    for name in ("input", "render", "mask", "gen", "viz"):
        assert (Path(cfg.save_dir) / f"{name}.mp4").stat().st_size > 0, name
    (depth,) = seen
    assert depth.shape == (9, 1, 64, 128) and np.isfinite(depth).all()
    assert cfg.render.near <= depth.min() and depth.max() <= cfg.render.far
    assert np.ptp(depth) > 0 and not np.allclose(depth[:, 0, :, 0], depth[:, 0, :, -1])
    assert {"depth", "prompt_encode", "denoise"} <= set(tc.timer.seconds)


def test_depth_int8_is_refused(tmp_path):
    """``--quant_depth int8`` is ported now (tests/test_torch_int8.py) and
    passes the check; a depth quantization the port does not have is still
    refused before anything is built, so it never runs as bf16 without a
    word."""
    check_supported(_cfg(tmp_path, "--quant_depth", "int8"))
    cfg = _cfg(tmp_path)
    check_supported(cfg)
    cfg.depth.quant = "fp8"
    with pytest.raises(NotImplementedError, match="--quant_depth fp8"):
        check_supported(cfg)
