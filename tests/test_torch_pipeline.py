"""The slice as a whole: the port's pipeline and orchestrator vs the JAX package.

``TrajCrafterPipeline`` of both packages, tiny VAE + 2-layer DiT in fp32 with
the same seeded weights (tests/torch_parity.py), runs 2 DDIM steps with CFG
6.0 from the same initial ``latents`` and the same ``noise_override``: VAE
encodes of the reference and masked videos, latent mask resize, noise aug,
the CFG denoise, the decode.  Final latents and decoded frames are compared.

Tolerance: 1e-4 absolute and relative.  Both sides are fp32; summation-order
differences (~1e-6) pass through the VAE encoder, two DiT steps whose CFG
combination multiplies the cond - uncond difference by 6, and the decoder.

Then a tiny ``infer_gradual`` of the port on the CPU writes all five mp4s,
and the entry points refuse what the port does not run yet.
"""

import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.cli import config_from_args, get_parser
from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.pipelines.trajcrafter import TrajCrafterPipeline as JaxPipeline
from trajectorycrafter_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.utils.convert import convert_dit, convert_vae
from trajectorycrafter_tpu_torch import cli
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_dev_models, build_models
from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline
from trajectorycrafter_tpu_torch.schedulers.ddim import DDIMScheduler
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax, vae_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
LC = 4
REPO = Path(__file__).resolve().parents[1]
VAE_KW = dict(latent_channels=LC, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
              norm_num_groups=4)
DIT_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=2 * LC + 1,
              out_channels=LC, time_embed_dim=16, text_embed_dim=32, num_layers=2,
              sample_width=12, sample_height=8, sample_frames=9, max_text_seq_length=7,
              cross_attn_dim_head=8, cross_attn_num_heads=4,
              use_rotary_positional_embeddings=True)


@pytest.fixture(scope="module")
def pipelines():
    vae_params = jax_tree(AutoencoderKLCogVideoX(**VAE_KW), 0, convert_vae, layers_per_block=1)
    dit_params = jax_tree(CrossTransformer3DModel(**DIT_KW), 1, convert_dit, num_layers=2)
    jpipe = JaxPipeline(
        vae=JaxVAE(**VAE_KW), vae_params=vae_params,
        transformer=JaxDiT(**DIT_KW, attention_impl="xla"), transformer_params=dit_params,
        scheduler=JaxDDIM(), dtype=jnp.float32)
    vae, dit = AutoencoderKLCogVideoX(**VAE_KW), CrossTransformer3DModel(**DIT_KW)
    vae.load_state_dict(vae_from_jax(vae_params), strict=True)
    dit.load_state_dict(dit_from_jax(dit_params), strict=True)
    tpipe = TrajCrafterPipeline(vae=vae.eval(), transformer=dit.eval(),
                                scheduler=DDIMScheduler(), dtype=torch.float32)
    return jpipe, tpipe


def _inputs(seed, strength):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    video = f32(rng.uniform(0, 1, (1, 9, 32, 48, 3)))
    mask = f32((rng.uniform(size=(1, 9, 32, 48, 1)) > 0.7) * 255.0)
    reference = f32(rng.uniform(0, 1, (1, 2, 32, 48, 3)))
    pe = f32(rng.standard_normal((1, 7, 32)))
    ne = f32(rng.standard_normal((1, 7, 32)))
    latents = f32(rng.standard_normal((1, 3, 4, 6, LC)))
    ref_noise = f32(rng.standard_normal((1, 1, 4, 6, LC)))
    aug_noise = f32(rng.standard_normal(video.shape))
    noise = (ref_noise, aug_noise)
    if strength < 1.0:  # img2img also draws the video posterior's noise
        noise = (ref_noise, f32(rng.standard_normal(latents.shape)), aug_noise)
    return (pe, ne, video, mask, reference), latents, noise


def _dynamic_guidance(scale: float, steps: int, t: int) -> float:
    """The cosine-power dynamic CFG of the reference pipeline, in float64."""
    return 1.0 + scale * (1.0 - math.cos(math.pi * ((steps - t) / steps) ** 5.0)) / 2.0


@pytest.mark.parametrize("dynamic_cfg,strength", [(False, 1.0), (True, 0.5)],
                         ids=["static_cfg", "dynamic_cfg_img2img"])
def test_pipeline_matches_jax(pipelines, dynamic_cfg, strength):
    """With ``use_dynamic_cfg`` the JAX side runs the port's guidance value as
    a static scale: the JAX package evaluates the dynamic-CFG cosine in fp32
    (pipelines/trajcrafter.py:497-499), where its argument pi*((N-t)/N)^5 is
    ~1e13 and fp32 rounding leaves the angle arbitrary, while the port, like
    the reference pipeline's Python math, evaluates it in float64.  At
    strength 0.5 of 2 steps one step runs, so one static scale is exact."""
    jpipe, tpipe = pipelines
    args, latents, noise = _inputs(0, strength)
    kw = dict(num_inference_steps=2, strength=strength)
    jax_guidance = 6.0
    if dynamic_cfg:
        t = int(DDIMScheduler().set_timesteps(2).timesteps[1])
        jax_guidance = _dynamic_guidance(6.0, 2, t)
    out = {}
    for output_type in ("latent", "np"):
        want = np.asarray(jpipe(*(jnp.asarray(a) for a in args), key=jax.random.PRNGKey(0),
                                latents=jnp.asarray(latents), output_type=output_type,
                                noise_override=tuple(jnp.asarray(n) for n in noise),
                                guidance_scale=jax_guidance, **kw))
        got = tpipe(*(torch.from_numpy(a) for a in args), latents=torch.from_numpy(latents),
                    output_type=output_type,
                    noise_override=tuple(torch.from_numpy(n) for n in noise),
                    guidance_scale=6.0, use_dynamic_cfg=dynamic_cfg, **kw).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=output_type)
        out[output_type] = got
    assert out["latent"].shape == (1, 3, 4, 6, LC)
    assert out["np"].shape == (1, 9, 32, 48, 3)
    assert 0.0 <= out["np"].min() and out["np"].max() <= 1.0


def _cfg(tmp_path, *extra):
    args = get_parser().parse_args([
        "--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
        "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
        "--prompt", "a scene", "--quant", "none", "--diffusion_inference_steps", "2",
        "--video_length", "9", "--sample_size", "32", "48",
        "--model_name", str(tmp_path / "no_checkpoints"),
        "--out_dir", str(tmp_path), "--exp_name", "run", *extra])
    cfg = config_from_args(args)
    cfg.warp_size = (48, 80)  # no CLI flag: a tiny warp for the CPU
    return cfg


def test_infer_gradual_writes_five_mp4s(tmp_path):
    cfg = _cfg(tmp_path)
    tc = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu"))
    gen = tc.infer_gradual()
    assert gen.shape == (9, 32, 48, 3)
    assert np.isfinite(gen).all() and 0.0 <= gen.min() and gen.max() <= 1.0
    for name in ("input", "render", "mask", "gen", "viz"):
        path = Path(cfg.save_dir) / f"{name}.mp4"
        assert path.is_file() and path.stat().st_size > 0, path
    assert {"warp", "vae_encode", "denoise", "vae_decode"} <= set(tc.timer.seconds)


def test_entry_points_refuse_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="int8"):
        build_dev_models(_cfg(tmp_path, "--quant", "int8"))
    with pytest.raises(NotImplementedError, match="sampler"):
        build_dev_models(_cfg(tmp_path, "--sampler_name", "Euler"))
    with pytest.raises(FileNotFoundError, match="--allow_dev_stubs"):
        build_models(_cfg(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_models(_cfg(tmp_path, "--allow_dev_stubs"))
    (tmp_path / "no_checkpoints").mkdir()
    with pytest.raises(NotImplementedError, match="checkpoint loading"):
        build_models(_cfg(tmp_path, "--allow_dev_stubs"))
    cfg = _cfg(tmp_path)
    tc = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu"))
    for mode in (tc.infer_direct, tc.infer_bullet, tc.infer_zoom):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mode()
    argv = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
            "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--out_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="int8"):  # the default --quant
        cli.main(argv)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            cli.main(argv + ["--quant", "none"])
