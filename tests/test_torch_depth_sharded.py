"""The port's sharded depth stage (``parallel/frames.py``, the DepthCrafter
UNet's sharded twin in ``models/depthcrafter.py``, ``pipelines/depth.py
with_mesh``) vs the unsharded port and the JAX package, on the CPU, on the
tiny models of the JAX package's multichip dryrun (``__graft_entry__.py``:
UNet (8, 16, 16, 16), heads 2, cross dim 12, groups 4, one layer a block;
SVD VAE (32, 32, 64, 64)), built for JAX and carried across with
``svd_unet_from_jax`` / ``svd_vae_from_jax``, fp32.

One real gloo world of 4 ranks (tests/torch_worlds.py; the ranks' side is
tests/torch_parallel_workers.py ``depth_sharded``) runs every sharded case:

  * the UNet forward on this rank's slab of whole inputs (the CFG pair, 6
    frames), its output joined whole: under dp 2 x sp 2 at 16 latent rows
    (two blocks of 8, one a rank), under dp 1 x sp 2 x tp 2 at 24 (three
    blocks: 16 / 8), on 5 frames over dp 2 (3 / 2), and under dp 2 x sp 2
    with the UNet's transformers in int8 (``--quant_depth int8``);
  * the same under dp 2 x sp 2 with each planted fault of ``DEPTH_FAULTS``;
  * the pipeline, two windows of 4 with an overlap of 2 and 2 Euler steps,
    given the CLIP embeddings and each window's noise: 6 frames of 128 x 64
    under dp 2 x sp 2, 6 of 192 x 64 under sp 2 x tp 2, 5 of 128 x 64 with
    CFG (the encode's frames dealt 0 / 1 / 2 / 2 over the 4 ranks, the
    decode's one chunk on rank 3); with the tiny CLIP in place of the
    embeddings; in int8;
  * ``infer_gradual`` of the dev stack with the tiny depth stage under dp 2
    x sp 2 (9 frames at a warp size of 128 x 128: 5 / 4 frames, 8 / 8 latent
    rows).

Tolerances, with their reasons:
  * sharded against unsharded, for the port's UNet forward and pipeline
    and against the JAX package's unsharded ``DepthCrafterPipeline``: atol
    2e-4, rtol 1e-3, the JAX package's own sharded-versus-single tolerance
    (its dryrun, ``__graft_entry__.py``).  The halos and the gathered keys
    and values are exact, the GroupNorm statistics sum in another order.
    The unsharded port's UNet forward against the JAX UNet:
    tests/test_torch_depth.py's 1e-4.
  * the int8 cases, against the unsharded int8 port: a cosine above
    ``INT8_COS``, as the JAX package holds its own int8 UNet.  At these
    widths (8-16 channels) the tiny int8 UNet's output is chaotic: an input
    moved by 1e-7 relative (the GroupNorm sums' reassociation) flips a code
    somewhere, one flip moves the next layer's input by about half a step,
    and the output moves by ~2e-2 relative L2, as much as int8 differs from
    fp32 (tests/test_torch_int8.py says the same of the JAX package).
  * the planted faults: each must fail that comparison on the seam band
    (the latent rows within 2 of a row seam and the frames within 1 of a
    frame seam), where the sound forward holds.
  * ``infer_gradual``: the depth the warp gets, as the normalised disparity
    it was made from (10000 / (3900 depth), in [0, 1] where no clip bites),
    within the same tolerance of the unsharded twin's (the depth divides by
    that disparity, which multiplies its rounding near the nearest pixel);
    the video within one uint8 level (a reassociated sum can move a pixel
    across a rounding boundary).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_workers import DEPTH_FAULTS, depth_sharded
from torch_parity import jax_tree
from torch_worlds import run_world

from trajectorycrafter_tpu.models.depthcrafter import UNetSpatioTemporalConditionModel as JaxUNet
from trajectorycrafter_tpu.models.svd_vae import AutoencoderKLTemporalDecoder as JaxSVDVAE
from trajectorycrafter_tpu.pipelines.depth import DepthCrafterPipeline as JaxDepthPipeline
from trajectorycrafter_tpu.utils.convert import (
    convert_clip_vision,
    convert_svd_unet,
    convert_svd_vae,
)
from trajectorycrafter_tpu_torch import cli
from trajectorycrafter_tpu_torch.models.clip import CLIPVisionModelWithProjection
from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
from trajectorycrafter_tpu_torch.models.svd_vae import AutoencoderKLTemporalDecoder
from trajectorycrafter_tpu_torch.ops.int8 import quantize_depth_unet_
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_dev_models, depth_stage
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.frames import ROW_BLOCK, FrameRows
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes
from trajectorycrafter_tpu_torch.parallel.spatial import shard_spatially
from trajectorycrafter_tpu_torch.pipelines.depth import DepthCrafterPipeline
from trajectorycrafter_tpu_torch.utils.weights import (
    clip_from_jax,
    svd_unet_from_jax,
    svd_vae_from_jax,
)

torch.set_num_threads(1)
T = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]
WORLD = 4
SHARD_TOL = dict(atol=2e-4, rtol=1e-3)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
UNET_TINY = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                 num_attention_heads=(2, 2, 2, 2), cross_attention_dim=12, norm_num_groups=4)
VAE_TINY = dict(block_out_channels=(32, 32, 64, 64))
CLIP_TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, image_size=28, patch_size=14, projection_dim=12)
# the seam band: latent rows within 2 of a row seam, frames within 1 of a frame seam
BAND_ROWS, BAND_FRAMES = 2, 1
INT8_COS = 0.999


def _unet_args(seed: int, f: int, h: int, b: int = 2):
    """Whole inputs of the UNet: (B, F, h, 8, 8) samples, a timestep and
    CLIP embeddings per frame, the added time ids."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    sample = f32(rng.standard_normal((b, f, h, 8, 8)))
    t = f32(np.full((b,), 0.25 * np.log(2.5)))
    ctx = f32(rng.standard_normal((b, f, 1, 12)))
    added = f32([[6.0, 127.0, 0.02], [3.0, 80.0, 0.1]][:b])
    return sample, t, ctx, added


def _pipe_case(seed: int, f: int, h: int, guidance: float = 1.0, embeddings: bool = True):
    """Frames (f, h, 64, 3) and the pipeline's keyword arguments: two
    windows of 4 over them, 2 Euler steps, each window's noise given, and
    the CLIP embeddings unless ``embeddings`` is False."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (f, h, 64, 3)).astype(np.float32)
    kw = dict(num_inference_steps=2, guidance_scale=guidance, window_size=4, overlap=2,
              window_noises=[rng.standard_normal((4, h // 8, 8, 4)).astype(np.float32)
                             for _ in range(2)])
    if embeddings:
        kw["image_embeddings"] = rng.standard_normal((f, 1, 12)).astype(np.float32)
    return frames, kw


# case -> (mesh (dp, sp, tp), int8, whole inputs)
UNET_CASES = {"dp2_sp2": ((2, 2, 1), False, _unet_args(0, 6, 16)),
              "sp2_tp2_rows16_8": ((1, 2, 2), False, _unet_args(1, 6, 24)),
              "frames3_2_dp2_sp2": ((2, 2, 1), False, _unet_args(2, 5, 24)),
              "int8_dp2_sp2": ((2, 2, 1), True, _unet_args(3, 6, 16))}
FAULT_CASE = "dp2_sp2"
# case -> (mesh, int8, with CLIP, frames, keyword arguments)
PIPE_CASES = {"dp2_sp2": ((2, 2, 1), False, False, *_pipe_case(4, 6, 128)),
              "sp2_tp2_rows16_8": ((1, 2, 2), False, False, *_pipe_case(5, 6, 192)),
              "frames5_cfg_dp2_sp2": ((2, 2, 1), False, False, *_pipe_case(6, 5, 128, 2.5)),
              "clip_dp2_sp2": ((2, 2, 1), False, True, *_pipe_case(7, 6, 128, embeddings=False)),
              "int8_dp2_sp2": ((2, 2, 1), True, False, *_pipe_case(8, 6, 128))}
JAX_PIPE_CASES = ("dp2_sp2", "sp2_tp2_rows16_8")
GRADUAL_MESH = (2, 2, 1)
GRADUAL_WARP = (128, 128)


@pytest.fixture(scope="module")
def params():
    unet = jax_tree(UNetSpatioTemporalConditionModel(**UNET_TINY), 0, convert_svd_unet,
                    layers_per_block=1)
    vae = jax_tree(AutoencoderKLTemporalDecoder(**VAE_TINY), 1, convert_svd_vae)
    clip = jax_tree(CLIPVisionModelWithProjection(**CLIP_TINY), 2, convert_clip_vision,
                    num_layers=2)
    return {"unet": unet, "vae": vae, "clip": clip}


@pytest.fixture(scope="module")
def weights(params):
    state = {"unet": svd_unet_from_jax(params["unet"]), "vae": svd_vae_from_jax(params["vae"]),
             "clip": clip_from_jax(params["clip"])}
    out = {name: {k: v.numpy() for k, v in sd.items()} for name, sd in state.items()}
    out["dims"] = {"unet": UNET_TINY, "vae": VAE_TINY, "clip": CLIP_TINY}
    return out


def _gradual_argv(tmp_path):
    return ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
            "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
            "--prompt", "a scene", "--diffusion_inference_steps", "2", "--video_length", "9",
            "--sample_size", "32", "48", "--quant", "none", "--depth_inference_steps", "2",
            "--model_name", str(tmp_path / "no_checkpoints"),
            "--out_dir", str(tmp_path), "--exp_name", "run"]


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    gradual_dir = tmp_path_factory.mktemp("gradual_depth_sharded")
    return run_world(depth_sharded, WORLD, tmp_path_factory.mktemp("depth_sharded"), weights,
                     UNET_CASES, PIPE_CASES, FAULT_CASE,
                     (_gradual_argv(gradual_dir), GRADUAL_WARP, GRADUAL_MESH))


def _models(weights, quant=False):
    from torch_parallel_workers import _depth_stage_models

    return _depth_stage_models(weights, quant)


def _unsharded_forward(weights, case):
    _, quant, args = UNET_CASES[case]
    unet = _models(weights, quant)[0]
    with torch.no_grad():
        return unet(*map(T, args)).numpy()


def _unsharded_pipe(weights, case):
    _, quant, with_clip, frames, kw = PIPE_CASES[case]
    unet, vae, clip = _models(weights, quant)
    pipe = DepthCrafterPipeline(unet=unet, vae=vae, image_encoder=clip if with_clip else None,
                                dtype=torch.float32)
    return pipe(frames, **kw)


def _band(f: int, h: int, mesh) -> np.ndarray:
    """(F, h) bool: the latent rows within ``BAND_ROWS`` of a row seam and
    the frames within ``BAND_FRAMES`` of a frame seam of ``mesh``."""
    part = FrameRows(*(D.Axis(n, s, 0, tuple(range(s))) for n, s in
                       (("dp", mesh[0]), ("sp", mesh[1]), ("plane", mesh[0] * mesh[1]))))
    near = lambda n, sizes, width: np.array(
        [any(abs(i + 0.5 - sum(sizes[:k])) < width for k in range(1, len(sizes)))
         for i in range(n)])
    return (near(f, part.frame_extents(f), BAND_FRAMES)[:, None]
            | near(h, part.row_extents(h), BAND_ROWS)[None, :])


def _holds(got, want, band) -> bool:
    return np.allclose(got[:, band], want[:, band], **SHARD_TOL)


def _assert_agrees(got, want, quant: bool):
    """``SHARD_TOL``, or for an int8 case a cosine above ``INT8_COS``."""
    assert got.shape == want.shape and np.isfinite(got).all()
    if not quant:
        np.testing.assert_allclose(got, want, **SHARD_TOL)
        return
    g, w = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    assert g @ w / np.linalg.norm(g) / np.linalg.norm(w) > INT8_COS


# ----------------------------------------------------------------------------
# the UNet forward
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", UNET_CASES)
def test_sharded_unet_forward_equals_the_unsharded_port(world, weights, case):
    """Every rank's joined output against the unsharded port's; each rank
    held its slab: its frames of dp and its rows of sp, in whole blocks."""
    want = _unsharded_forward(weights, case)
    (dp, sp, tp), quant, (sample, *_) = UNET_CASES[case]
    f, h = sample.shape[1:3]
    for run in world:
        got = run["unet"][case]
        assert want.shape == (2, f, h, 8, 4)
        _assert_agrees(got["out"], want, quant)
        i, j, _ = got["coords"]
        assert got["slab"] == (shard_sizes(f, dp)[i],
                               ROW_BLOCK * shard_sizes(h // ROW_BLOCK, sp)[j])


def test_the_unsharded_unet_forward_holds_to_jax(params, weights):
    """The unsharded port on the fault case's inputs against the JAX UNet,
    which closes the chain sharded port -> unsharded port -> JAX."""
    args = UNET_CASES[FAULT_CASE][2]
    want = np.asarray(jax.jit(JaxUNet(**UNET_TINY).apply)({"params": params["unet"]},
                                                           *map(jnp.asarray, args)))
    np.testing.assert_allclose(_unsharded_forward(weights, FAULT_CASE), want, **JAX_TOL)


@pytest.mark.parametrize("fault", DEPTH_FAULTS)
def test_planted_faults_fail_on_the_seam_band(world, weights, fault):
    """A zero row or frame halo, a slab-local GroupNorm, local frame ids
    and keys and values left ungathered each move the forward off the
    unsharded port's on the seam band, where the sound forward holds."""
    mesh, _, (sample, *_) = UNET_CASES[FAULT_CASE]
    want = _unsharded_forward(weights, FAULT_CASE)
    band = _band(*sample.shape[1:3], mesh)
    assert band.any() and not band.all()
    sound = [run["unet"][FAULT_CASE]["out"] for run in world]
    wrong = [run["faults"][fault] for run in world]
    assert all(_holds(s, want, band) for s in sound)
    assert not any(_holds(w, want, band) for w in wrong), f"{fault} passed"


@pytest.mark.parametrize("case", UNET_CASES)
def test_every_rank_exchanges_halos_norms_and_keys(world, case):
    """Each rank's forward exchanged row or frame halos, GroupNorm sums and
    self-attention keys and values; nothing under the old names."""
    for run in world:
        t = run["unet"][case]["transport"]
        for name in ("depth_halo", "depth_norm", "depth_kv"):
            assert t.get(f"{name} direct", 0) > 0 and t.get(f"{name} direct bytes", 0) > 0, name
        assert not {"halo direct", "norm direct"} & set(t)


# ----------------------------------------------------------------------------
# the pipeline
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", PIPE_CASES)
def test_sharded_pipeline_equals_the_unsharded_port(world, weights, case):
    """Every rank returns the whole raw disparity, within the tolerance of
    the unsharded pipeline's and bit-equal to every other rank's."""
    want = _unsharded_pipe(weights, case)
    _, quant, _, frames, _ = PIPE_CASES[case]
    assert want.shape == frames.shape[:3] and want.std() > 0.01
    for run in world:
        got = run["pipe"][case]["raw"]
        _assert_agrees(got, want, quant)
        np.testing.assert_array_equal(got, world[0]["pipe"][case]["raw"])


@pytest.mark.parametrize("case", JAX_PIPE_CASES)
def test_sharded_pipeline_equals_jax(world, params, case):
    """The sharded pipeline against the JAX package's unsharded one on the
    same frames, embeddings and noise (the dryrun's check)."""
    _, _, _, frames, kw = PIPE_CASES[case]
    want = JaxDepthPipeline(unet=JaxUNet(**UNET_TINY), unet_params=params["unet"],
                            vae=JaxSVDVAE(**VAE_TINY), vae_params=params["vae"],
                            dtype=jnp.float32)(frames, **kw)
    np.testing.assert_allclose(world[0]["pipe"][case]["raw"], want, **SHARD_TOL)


@pytest.mark.parametrize("case", PIPE_CASES)
def test_every_rank_joins_frames_and_windows(world, case):
    """The frames travel in one ``all_gather`` per stage (the CLIP
    embeddings where CLIP runs, the encode's means, the decoded disparity)
    and each window's latents in one per split axis of the plane."""
    (dp, sp, _), _, with_clip, frames, kw = PIPE_CASES[case]
    windows = len(kw["window_noises"])
    for run in world:
        t = run["pipe"][case]["transport"]
        assert t["depth_frames direct"] == 2 + with_clip
        assert t["depth_latents direct"] == windows * ((dp > 1) + (sp > 1))


# ----------------------------------------------------------------------------
# infer_gradual
# ----------------------------------------------------------------------------


def test_sharded_infer_gradual_matches_its_unsharded_twin(world, weights, tmp_path):
    """``infer_gradual`` with the tiny depth stage under dp 2 x sp 2: every
    rank ran its share of the depth stage and got the whole depth, the
    leader's video is the unsharded twin's; only the leader writes."""
    cfg = cli.parse_config(_gradual_argv(tmp_path))
    cfg.warp_size = GRADUAL_WARP
    models = build_dev_models(cfg, "cpu")
    unet, vae, clip = _models(weights)
    infer = depth_stage(unet, vae, clip, torch.float32)
    depths = []
    models.depth_infer = lambda *a, **kw: depths.append(infer(*a, **kw)) or depths[-1]
    want = TrajCrafter(cfg, models=models).infer_gradual()
    lead = world[0]["gradual"]
    assert lead["gen"].shape == want.shape == (9, 32, 48, 3)
    assert np.abs(lead["gen"] - want).max() <= 1.0 / 255.0 + 1e-6
    (want_depth,) = depths
    assert want_depth.shape == (9, 1) + GRADUAL_WARP and np.ptp(want_depth) > 0
    disparity = lambda depth: 10000.0 / 3900.0 / depth
    for run in world:
        got = run["gradual"]
        assert got["sharded"]
        np.testing.assert_array_equal(got["depth"], lead["depth"])
        np.testing.assert_allclose(disparity(got["depth"]), disparity(want_depth), **SHARD_TOL)
        assert {"handoff", "depth"} <= set(got["stages"])
        assert got["transport"]["depth_latents direct"] > 0
    assert {"prompt_encode", "write_mp4"} <= set(lead["stages"])
    for run in world[1:]:  # every rank gets the video back
        np.testing.assert_array_equal(run["gradual"]["gen"], lead["gen"])
    assert not {"prompt_encode", "write_mp4"} & set(world[1]["gradual"]["stages"])


# ----------------------------------------------------------------------------
# the partition's rules, without a world
# ----------------------------------------------------------------------------


def _part(dp: int, sp: int, i: int = 0, j: int = 0) -> FrameRows:
    axis = lambda name, n, k: D.Axis(name, n, k, tuple(range(n)))
    return FrameRows(axis("dp", dp, i), axis("sp", sp, j), axis("plane", dp * sp, i * sp + j))


def test_rows_split_in_whole_blocks_so_every_level_shares_its_seams():
    """72 latent rows (576x1024) over sp 2: 40 / 32, and every level of the
    UNet halves both (20 / 16, 10 / 8, 5 / 4) on the same global seam."""
    slab = _part(1, 2, 0, 1).layout(49, 72)
    assert slab.rows == (40, 32) and slab.row_start == 40 and slab.num_rows == 32
    assert [slab.rows_at(32 >> k) for k in range(4)] == [[40, 32], [20, 16], [10, 8], [5, 4]]
    frames = _part(2, 2, 1, 0).layout(9, 72)
    assert frames.frames == (5, 4) and frames.frame_start == 5
    assert frames.frame_ids("cpu").tolist() == [5.0, 6.0, 7.0, 8.0]
    x = torch.arange(9 * 72).reshape(9, 72)
    assert torch.equal(frames.take(x, 0, 1), x[5:, :40])


def test_whole_frames_and_chunks_are_dealt_from_the_last_rank_back():
    """The leader, which also reads, captions, makes the poses and encodes
    the prompt, gets the fewest frames and decode chunks."""
    from trajectorycrafter_tpu_torch.parallel.frames import deal, frame_share

    world = lambda i: D.Axis("world", 4, i, (0, 1, 2, 3))
    assert deal(9, world(0)) == [0, 3, 3, 3] and deal(13, world(0)) == [1, 4, 4, 4]
    assert [frame_share(9, world(i))[:2] for i in range(4)] == [(0, 0), (0, 3), (3, 3), (6, 3)]
    assert [frame_share(5, world(i))[:2] for i in range(4)] == [(0, 0), (0, 1), (1, 2), (3, 2)]


def test_the_partition_raises_where_a_split_cannot_be_made():
    with pytest.raises(ValueError, match="no multiple of 8"):
        _part(1, 2).row_extents(20)
    with pytest.raises(ValueError, match="without rows"):
        _part(1, 2).row_extents(8)
    with pytest.raises(ValueError, match="without frames"):
        _part(2, 1).frame_extents(1)
    assert _part(2, 2).row_extents(24) == [16, 8] and _part(2, 2).frame_extents(5) == [3, 2]


def test_a_sharded_unet_takes_the_whole_height_and_its_own_slab():
    """The twin shares the UNet's weights and raises where its slab is not
    the partition's, before any collective."""
    unet = UNetSpatioTemporalConditionModel(**UNET_TINY)
    twin = shard_spatially(unet, _part(2, 2))
    assert twin.plane is not None and unet.plane is None
    assert twin.conv_in.weight is unet.conv_in.weight
    args = [T(a) for a in _unet_args(0, 6, 16)]
    with pytest.raises(ValueError, match="whole latent height"):
        twin(args[0][:, :3, :8], *args[1:])
    with pytest.raises(ValueError, match="is not this rank's"):
        twin(args[0][:, :2, :8], *args[1:], height=16)


def test_depth_int8_quantizes_the_twin_it_shares():
    """An int8 UNet's twin runs the same int8 layers (no copy of the
    weights), so ``--quant_depth int8`` shards as it is."""
    unet = UNetSpatioTemporalConditionModel(**UNET_TINY)
    quantize_depth_unet_(unet)
    twin = shard_spatially(unet, _part(2, 2))
    layer = unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q
    twin_layer = twin.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q
    assert type(twin_layer) is type(layer) and twin_layer.weight_q is layer.weight_q
