"""The slice as a whole: the port's pipeline and orchestrator vs the JAX package.

``TrajCrafterPipeline`` of both packages, tiny VAE + 2-layer DiT in fp32 with
the same seeded weights (tests/torch_parity.py), runs 2 DDIM steps with CFG
6.0 from the same initial ``latents`` and the same ``noise_override``: VAE
encodes of the reference and masked videos, latent mask resize, noise aug,
the CFG denoise, the decode.  Final latents and decoded frames are compared.

Tolerance: 1e-4 absolute and relative.  Both sides are fp32; summation-order
differences (~1e-6) pass through the VAE encoder, two DiT steps whose CFG
combination multiplies the cond - uncond difference by 6, and the decoder.

The int8 pipeline (``--quant int8``: the DiT's blocks and Perceivers
quantized, tests/test_torch_int8.py) against the JAX int8 pipeline on the
same seeded weights: 1e-4 of the latents' largest magnitude, since both
quantize to the same codes at this size (the reason is stated in
test_torch_int8.py); a per-tensor activation scale planted in the port's
quantization fails it.  As the JAX package's own int8 pipeline test does,
its latents also keep a cosine > 0.99 with the fp32 chain's.

Then a tiny ``infer_gradual`` of the port on the CPU writes all five mp4s,
with the default ``--quant int8`` and with ``--quant none``, and the entry
points refuse only an unknown quantization or sampler.  Last, both
packages' ``infer_gradual`` at a sample size equal to the warp size (the
deployed 576x1024's branch, at 144x256) on the same tiny pipelines: the
conditions and mp4s bit-equal, the final latents to the tolerance above.
"""

import dataclasses
import math
from unittest import mock
from pathlib import Path

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree, per_tensor_quantize_rows

from trajectorycrafter_tpu_torch.cli import config_from_args, get_parser
from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.ops.int8 import quantize_dit_params
from trajectorycrafter_tpu.pipelines.trajcrafter import TrajCrafterPipeline as JaxPipeline
from trajectorycrafter_tpu.schedulers import SCHEDULER_REGISTRY as JAX_REGISTRY
from trajectorycrafter_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.utils.convert import convert_dit, convert_vae
from trajectorycrafter_tpu_torch import cli
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.ops import int8_matmul
from trajectorycrafter_tpu_torch.ops.int8 import int8_linears, quantize_dit_, quantized_twin
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_dev_models, build_models
from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline
from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY
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


SAMPLER_CASES = [
    pytest.param("DDIM_Origin", False, 1.0, 2, id="static_cfg"),
    pytest.param("DDIM_Origin", True, 0.5, 2, id="dynamic_cfg_img2img"),
    pytest.param("DDIM_Cog", False, 1.0, 2, id="DDIM_Cog"),
    pytest.param("Euler", False, 1.0, 2, id="Euler"),
    pytest.param("Euler A", False, 1.0, 2, id="Euler_A"),
    pytest.param("DPM++", False, 1.0, 3, id="DPM++"),
    pytest.param("DPM++", False, 0.5, 6, id="DPM++_img2img"),
    pytest.param("PNDM", False, 1.0, 4, id="PNDM"),
]


@pytest.mark.parametrize("sampler,dynamic_cfg,strength,steps", SAMPLER_CASES)
def test_pipeline_matches_jax(pipelines, sampler, dynamic_cfg, strength, steps):
    """With ``use_dynamic_cfg`` the JAX side runs the port's guidance value as
    a static scale: the JAX package evaluates the dynamic-CFG cosine in fp32
    (pipelines/trajcrafter.py:497-499), where its argument pi*((N-t)/N)^5 is
    ~1e13 and fp32 rounding leaves the angle arbitrary, while the port, like
    the reference pipeline's Python math, evaluates it in float64.  At
    strength 0.5 of 2 steps one step runs, so one static scale is exact.

    Every sampler of the registry runs with its deployed config: DPM++ at 3
    steps (the middle one second order) and at strength 0.5 of 6 (steps 3-5:
    first, second, first order), PNDM at 4 (its 12 pseudo-RK calls and one
    PLMS call).  Euler and Euler A start from the latents times
    ``init_noise_sigma`` (~4,096, so ~18,000 at most here), and their first
    step cancels those down to O(1): a rounding there, where XLA fuses a
    multiply-add and torch does not, is one fp32 ulp at that magnitude, ~2e-3.
    Both Euler paths are held to that ulp, relative to the largest magnitude
    they hold, in the latents and the decoded frames (they differ by ~2e-4).
    Euler A takes the same ``ancestral_noise_override`` on both sides: the JAX
    package draws its noise with ``fold_in``, which torch cannot replay."""
    jpipe, tpipe = pipelines
    jpipe = dataclasses.replace(jpipe, scheduler=JAX_REGISTRY[sampler]())
    tpipe = dataclasses.replace(tpipe, scheduler=SCHEDULER_REGISTRY[sampler]())
    args, latents, noise = _inputs(0, strength)
    kw = dict(num_inference_steps=steps, strength=strength)
    jkw, tkw = {}, {}
    if sampler == "Euler A":
        ancestral = np.random.default_rng(9).standard_normal(
            (steps, *latents.shape)).astype(np.float32)
        jkw["ancestral_noise_override"] = jnp.asarray(ancestral)
        tkw["ancestral_noise_override"] = torch.from_numpy(ancestral)
    # one fp32 ulp at the largest magnitude the Euler samplers hold
    sigma_max = tpipe.scheduler.set_timesteps(steps).init_noise_sigma
    euler_bound = float(np.spacing(np.float32(np.abs(latents).max() * sigma_max)))
    jax_guidance = 6.0
    if dynamic_cfg:
        t = int(DDIMScheduler().set_timesteps(2).timesteps[1])
        jax_guidance = _dynamic_guidance(6.0, 2, t)
    out = {}
    for output_type in ("latent", "np"):
        want = np.asarray(jpipe(*(jnp.asarray(a) for a in args), key=jax.random.PRNGKey(0),
                                latents=jnp.asarray(latents), output_type=output_type,
                                noise_override=tuple(jnp.asarray(n) for n in noise),
                                guidance_scale=jax_guidance, **kw, **jkw))
        got = tpipe(*(torch.from_numpy(a) for a in args), latents=torch.from_numpy(latents),
                    output_type=output_type,
                    noise_override=tuple(torch.from_numpy(n) for n in noise),
                    guidance_scale=6.0, use_dynamic_cfg=dynamic_cfg, **kw, **tkw).numpy()
        if sampler.startswith("Euler"):
            assert np.abs(got - want).max() <= euler_bound, output_type
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=output_type)
        out[output_type] = got
    assert out["latent"].shape == (1, 3, 4, 6, LC)
    assert out["np"].shape == (1, 9, 32, 48, 3)
    assert 0.0 <= out["np"].min() and out["np"].max() <= 1.0


def test_pndm_refuses_img2img_as_jax(pipelines):
    jpipe, tpipe = pipelines
    jpipe = dataclasses.replace(jpipe, scheduler=JAX_REGISTRY["PNDM"]())
    tpipe = dataclasses.replace(tpipe, scheduler=SCHEDULER_REGISTRY["PNDM"]())
    args, latents, noise = _inputs(0, 0.5)
    kw = dict(num_inference_steps=4, strength=0.5, output_type="latent")
    with pytest.raises(NotImplementedError, match="PNDM") as want:
        jpipe(*(jnp.asarray(a) for a in args), key=jax.random.PRNGKey(0),
              latents=jnp.asarray(latents), noise_override=tuple(jnp.asarray(n) for n in noise),
              **kw)
    with pytest.raises(NotImplementedError, match="PNDM") as got:
        tpipe(*(torch.from_numpy(a) for a in args), latents=torch.from_numpy(latents),
              noise_override=tuple(torch.from_numpy(n) for n in noise), **kw)
    assert str(got.value) == str(want.value)


def test_int8_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    jpipe8 = dataclasses.replace(jpipe, transformer=jpipe.transformer.clone(quant="int8"),
                                 transformer_params=quantize_dit_params(jpipe.transformer_params))
    tpipe8 = dataclasses.replace(tpipe, transformer=quantized_twin(tpipe.transformer,
                                                                   quantize_dit_))
    assert int8_linears(tpipe8.transformer) == 2 * 6 + 1 * 3
    assert int8_linears(tpipe.transformer) == 0  # the twin shares, and leaves, the fp32 DiT
    args, latents, noise = _inputs(0, 1.0)
    kw = dict(num_inference_steps=2, guidance_scale=6.0, output_type="latent")
    want = np.asarray(jpipe8(*(jnp.asarray(a) for a in args), key=jax.random.PRNGKey(0),
                             latents=jnp.asarray(latents),
                             noise_override=tuple(jnp.asarray(n) for n in noise), **kw))

    def run(pipe):
        return pipe(*(torch.from_numpy(a) for a in args), latents=torch.from_numpy(latents),
                    noise_override=tuple(torch.from_numpy(n) for n in noise), **kw).numpy()

    got = run(tpipe8)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    with mock.patch.object(int8_matmul, "quantize_rows_reference", per_tensor_quantize_rows):
        assert np.abs(run(tpipe8) - want).max() > 1e-4 * scale
    fp32 = run(tpipe).ravel()
    cos = float(got.ravel() @ fp32 / (np.linalg.norm(got) * np.linalg.norm(fp32)))
    assert cos > 0.99, f"int8 sampling diverged from fp32: cosine {cos}"


def _cfg(tmp_path, *extra):
    args = get_parser().parse_args([
        "--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
        "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
        "--prompt", "a scene", "--diffusion_inference_steps", "2",
        "--video_length", "9", "--sample_size", "32", "48",
        "--model_name", str(tmp_path / "no_checkpoints"),
        "--out_dir", str(tmp_path), "--exp_name", "run", *extra])
    cfg = config_from_args(args)
    cfg.warp_size = (48, 80)  # no CLI flag: a tiny warp for the CPU
    return cfg


def _infer_gradual_writes_five_mp4s(cfg):
    tc = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu"))
    gen = tc.infer_gradual()
    assert gen.shape == (9, 32, 48, 3)
    assert np.isfinite(gen).all() and 0.0 <= gen.min() and gen.max() <= 1.0
    for name in ("input", "render", "mask", "gen", "viz"):
        path = Path(cfg.save_dir) / f"{name}.mp4"
        assert path.is_file() and path.stat().st_size > 0, path
    assert {"warp", "vae_encode", "denoise", "vae_decode"} <= set(tc.timer.seconds)
    return tc.models.pipeline.transformer


def test_infer_gradual_writes_five_mp4s(tmp_path):
    """The default ``--quant int8``: the DiT's blocks and Perceivers run int8."""
    dit = _infer_gradual_writes_five_mp4s(_cfg(tmp_path))
    assert int8_linears(dit) == 6 * len(dit.transformer_blocks) \
        + 3 * len(dit.perceiver_cross_attention)


def test_infer_gradual_bf16_writes_five_mp4s(tmp_path):
    dit = _infer_gradual_writes_five_mp4s(_cfg(tmp_path, "--quant", "none"))
    assert int8_linears(dit) == 0


def test_entry_points_refuse_only_an_unknown_quant_or_sampler(tmp_path):
    """Every sampler of the registry and every mode runs now (the modes are
    driven in tests/test_torch_modes.py); the entry points still refuse a
    quantization the port does not have and a sampler name it does not
    know, before any model is built."""
    cfg = _cfg(tmp_path, "--quant", "int8", "--quant_depth", "int8")
    assert build_dev_models(cfg).pipeline.transformer is not None
    cfg.diffusion.quant = "fp8"
    with pytest.raises(NotImplementedError, match="--quant fp8"):
        build_dev_models(cfg)
    for sampler in SCHEDULER_REGISTRY:
        pipeline = build_dev_models(_cfg(tmp_path, "--sampler_name", sampler)).pipeline
        assert type(pipeline.scheduler) is type(SCHEDULER_REGISTRY[sampler]())
    cfg = _cfg(tmp_path)
    cfg.diffusion.sampler_name = "Heun"
    with pytest.raises(NotImplementedError, match="unknown sampler 'Heun'"):
        build_dev_models(cfg)
    with pytest.raises(FileNotFoundError, match="--allow_dev_stubs"):
        build_models(_cfg(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_models(_cfg(tmp_path, "--allow_dev_stubs"))
    (tmp_path / "no_checkpoints").mkdir()  # a tree that exists is loaded: this one is empty
    with pytest.raises(ValueError, match="vae: checkpoint key set does not match"):
        build_models(_cfg(tmp_path, "--allow_dev_stubs"), device="cpu")
    argv = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
            "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--out_dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            cli.main(argv)  # the default --quant int8


# a small 9:16 sample size, the deployed 576x1024's shape: the smallest whose
# latent grid (18 x 32) the DiT's 2 x 2 patches tile
SMALL_9_16 = (144, 256)


class _FixedDraws:
    """A pipeline whose initial latents and noise draws are fixed arrays (the
    two packages cannot replay each other's generators); each call also
    records its arguments and its final latents (``output_type="latent"``)."""

    def __init__(self, pipe, latents, noise, to):
        self.pipe, self.calls = pipe, []
        self.fixed = dict(latents=to(latents), noise_override=tuple(to(n) for n in noise))

    def __getattr__(self, name):  # device, timer, vae, transformer ...
        return getattr(self.pipe, name)

    def __call__(self, *args, **kwargs):
        kwargs = {**kwargs, **self.fixed}
        final = self.pipe(*args, **{**kwargs, "output_type": "latent"})
        self.calls.append(([np.asarray(a) for a in args], np.asarray(final)))
        return self.pipe(*args, **kwargs)


def _mp4_frames(path):
    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            return np.stack(frames)
        frames.append(frame)


def test_infer_gradual_at_warp_size_matches_jax(tmp_path, pipelines, monkeypatch):
    """``infer_gradual`` where the warp already has ``sample_size`` (the
    deployed 576x1024 diffusion, here a small 9:16 size): on both sides
    ``_fetch_cond`` resizes the render and the mask to their own size and
    ``_diffuse_and_save`` takes the frames, the render and the mask as they
    are.  The two packages run it on the test clip with the plane depth, a
    fixed caption and prompt embeddings, and the tiny fp32 pipelines of
    ``pipelines`` with the same initial latents and noise draws.

    The two warps agree within the bounds of tests/test_torch_warp.py (hole
    masks on all but 0.5% of the pixels; colours to 1e-3 where both are
    known, but on at most 3% knife-edge pixels), and a knife-edge pixel
    moves a uint8 level of the render; so the JAX run takes the port's warp
    output, and from there on the two runs see the same numbers.  Then the
    reference frames handed to the pipeline are the frames read at the warp
    size, bit for bit, on both sides; the render and mask conditions are
    bit-equal; the input, render and mask mp4s decode to the same frames;
    the final latents agree to ``TOL``, the pipeline test's."""
    from trajectorycrafter_tpu import cli as jax_cli
    from trajectorycrafter_tpu import orchestrator as jax_orchestrator
    from trajectorycrafter_tpu_torch import orchestrator

    jpipe, tpipe = pipelines
    hs, ws = SMALL_9_16
    rng = np.random.default_rng(11)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    pe, ne = f32(1, 7, 32), f32(1, 7, 32)
    latents = f32(1, 3, hs // 8, ws // 8, LC)
    noise = (f32(1, 3, hs // 8, ws // 8, LC), f32(1, 9, hs, ws, 3))  # ref frames 9 -> 3
    argv = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
            "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
            "--prompt", "a scene", "--diffusion_inference_steps", "2",
            "--video_length", "9", "--sample_size", str(hs), str(ws)]

    def configure(cfg, name):
        cfg.warp_size = SMALL_9_16
        # the deployed intrinsics (576x1024) scaled to the warp size
        cfg.render.focal, cfg.render.cx, cfg.render.cy = 125.0, 128.0, 72.0
        cfg.out_dir, cfg.exp_name = str(tmp_path), name
        cfg.save_dir = str(tmp_path / name)
        return cfg

    warps = {}
    port_warp, jax_warp = orchestrator.forward_warp_batch, jax_orchestrator.forward_warp_batch

    def recorded_port_warp(*args, **kwargs):
        warps["port"] = port_warp(*args, **kwargs)
        return warps["port"]

    def jax_warp_taking_the_ports(*args, **kwargs):
        warps["jax"] = jax_warp(*args, **kwargs)
        return tuple(jnp.asarray(x.numpy()) for x in warps["port"])

    monkeypatch.setattr(orchestrator, "forward_warp_batch", recorded_port_warp)
    monkeypatch.setattr(jax_orchestrator, "forward_warp_batch", jax_warp_taking_the_ports)
    tcfg = configure(cli.parse_config(argv), "port")
    tfixed = _FixedDraws(tpipe, latents, noise, torch.from_numpy)
    ttc = TrajCrafter(tcfg, models=orchestrator.ModelBundle(
        pipeline=tfixed, depth_infer=orchestrator._plane_depth_infer,
        encode_prompt=lambda p, n: (torch.from_numpy(pe), torch.from_numpy(ne)),
        get_caption=lambda frame: "a scene"))
    tgen = ttc.infer_gradual()

    jcfg = configure(jax_cli.config_from_args(jax_cli.get_parser().parse_args(argv)), "jax")
    jfixed = _FixedDraws(jpipe, latents, noise, jnp.asarray)
    jtc = jax_orchestrator.TrajCrafter(jcfg, models=jax_orchestrator.ModelBundle(
        pipeline=jfixed, depth_infer=jax_orchestrator._plane_depth_infer,
        encode_prompt=lambda p, n: (jnp.asarray(pe), jnp.asarray(ne)),
        get_caption=lambda frame: "a scene"))
    jgen = jtc.infer_gradual()

    (twarped, tmask), (jwarped, jmask) = ((np.asarray(x) for x in warps[side][:2])
                                          for side in ("port", "jax"))
    assert twarped.shape == (9, hs, ws, 3) and tmask.shape == (9, hs, ws)
    assert np.mean(tmask != jmask) <= 0.005
    both = (tmask > 0) & (jmask > 0)
    assert 0.1 < both.mean() < 1.0  # the views overlap, with holes
    assert (np.abs(twarped - jwarped).max(-1) > 1e-3)[both].mean() <= 0.03

    (jargs, jlat), = jfixed.calls
    (targs, tlat), = tfixed.calls
    frames = ttc._load_frames()
    assert frames.shape == (9, hs, ws, 3)
    np.testing.assert_array_equal(targs[4][0], frames)  # the reference frames, not resized
    np.testing.assert_array_equal(targs[4], jargs[4])
    assert targs[2].shape == (1, 9, hs, ws, 3) and targs[3].shape == (1, 9, hs, ws, 1)
    np.testing.assert_array_equal(targs[2], jargs[2])  # render
    np.testing.assert_array_equal(targs[3], jargs[3])  # mask, 255 = hole
    for name in ("input", "render", "mask"):
        got, want = (_mp4_frames(tmp_path / side / f"{name}.mp4") for side in ("port", "jax"))
        assert got.shape == (9, hs, ws, 3)
        np.testing.assert_array_equal(got, want)
    assert tlat.shape == (1, 3, hs // 8, ws // 8, LC)
    np.testing.assert_allclose(tlat, jlat, **TOL)
    assert tgen.shape == jgen.shape == (9, hs, ws, 3)
