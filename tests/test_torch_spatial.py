"""The port's sharded warp and spatially sharded CogVideoX VAE
(``ops/splat.py forward_warp_batch(..., mesh)``, ``parallel/spatial.py``,
``models/vae.py`` on a plane, ``pipelines/trajcrafter.py with_mesh``) vs the
unsharded port and the JAX package, on the CPU, at the sizes of the JAX
package's tests/test_multichip.py.

One real gloo world of 4 ranks (tests/torch_worlds.py; the ranks' side is
tests/torch_parallel_workers.py ``spatial``) runs every sharded case:

  * the warp of n = 6 frames, which do not split evenly over 4 ranks
    (``shard_sizes``: 2, 2, 2, 0), with and without mask cleaning, on
    tests/test_multichip.py's inputs (a depth drawn per pixel) and on
    tests/test_torch_warp.py's scene (a tilted depth plane);
  * the condition prep (``prepare_conditions`` with the noise given) and
    the decode of the tiny dev VAE, video (1, 5, 32, 48, 3) and latents
    (1, 2, 4, 6, 4), under dp 2 x sp 2 and dp 1 x sp 2 x tp 2, and an
    uneven split: 3 latent rows over dp 2 (video (1, 5, 24, 48, 3));
  * the same under dp 2 x sp 2 with each planted fault of
    ``SPATIAL_FAULTS`` (every halo zero, every GroupNorm on its slab);
  * ``infer_gradual`` of the dev stack (unquantized) under dp 2 x sp 2;
  * ``vae_decode_auto`` on the sharded twin under dp 2 x sp 2 and dp 1 x sp
    2 x tp 2 with a memory that forces strips (``STRIPS``: 3 latent frames
    of 9 x 12 in strips of 4 rows, tests/test_torch_vae.py's), each strip
    decoded on the plane and blended on every rank.

Tolerances, with their reasons:
  * the sharded warp against the unsharded port: equal.  Frames are
    independent and the CPU's ``index_add_`` adds in order.  Against the
    JAX package, on tests/test_torch_warp.py's scene: that file's bounds (a
    mask disagreement of at most 0.5% of the pixels, colours within 1e-3
    but on at most 3% of the known pixels).  Those bounds are stated for a
    smooth depth: on the per-pixel random depth the unsharded port's mask
    already parts from JAX's on 0.8% of the pixels (landings within
    rounding of a pixel edge), so that case is held to the port only.
  * the sharded condition latents and decoded frames against the unsharded
    port: atol 2e-4, rtol 1e-3, the JAX package's own sharded-versus-single
    tolerance (tests/test_multichip.py); the halos are exact, the GroupNorm
    statistics sum in another order.  Against the JAX package with no mesh:
    tests/test_torch_vae.py's 1e-4.
  * the planted faults: each must fail that comparison on the seam band
    (the rows and columns within 8 pixels, or 1 latent, of a seam), where
    a wrong halo shows; the sound run must pass it there too.
  * ``infer_gradual``: the generated video within one uint8 level of the
    unsharded twin's (the sharded VAE and denoise reassociate fp32 sums by
    ~1e-6, which can move a pixel across a rounding boundary);
  * the sharded strip decode: against the unsharded strip decode at the
    sharded-versus-single tolerance above, and against JAX's
    ``vae_decode_auto`` given the same memory at tests/test_torch_vae.py's
    1e-4.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_parallel_workers import SPATIAL_FAULTS, spatial
from torch_parity import jax_tree
from torch_worlds import run_world

from trajectorycrafter_tpu.geometry.cameras import default_c2w as jax_default_c2w
from trajectorycrafter_tpu.geometry.cameras import intrinsics_matrix as jax_intrinsics
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.models.vae import vae_decode_auto as jax_vae_decode_auto
from trajectorycrafter_tpu.ops.splat import forward_warp_batch as jax_forward_warp_batch
from trajectorycrafter_tpu.pipelines.trajcrafter import (
    _decode_jit,
    _prepare_conditions_override_jit,
)
from trajectorycrafter_tpu.utils.convert import convert_vae
from trajectorycrafter_tpu_torch import cli
from trajectorycrafter_tpu_torch.geometry.cameras import default_c2w, intrinsics_matrix
from trajectorycrafter_tpu_torch.geometry.trajectory import generate_traj_specified
from trajectorycrafter_tpu_torch.models.vae import (
    AutoencoderKLCogVideoX,
    decode_is_tiled,
    decode_peak_divisor,
    vae_decode,
    vae_decode_auto,
    vae_decode_tiled,
)
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_dev_models
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes
from trajectorycrafter_tpu_torch.parallel.spatial import Plane, seam_band, shard_spatially
from trajectorycrafter_tpu_torch.utils.weights import vae_from_jax

torch.set_num_threads(1)
T = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]
WORLD = 4
SHARD_TOL = dict(atol=2e-4, rtol=1e-3)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
MASK_DISAGREE_MAX = 0.005
KNIFE_EDGE_MAX = 0.03
DEV = dict(latent_channels=4, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
           norm_num_groups=4)
OUTPUTS = ("inpaint latents", "reference latents", "decoded video")


def _multichip_warp():
    """tests/test_multichip.py's: 6 frames of 24 x 32, a depth drawn per
    pixel, a translating camera."""
    rng = np.random.default_rng(1)
    n, h, w = 6, 24, 32
    frames = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    depths = rng.uniform(2, 4, (n, h, w)).astype(np.float32)
    pose_s = np.tile(np.asarray(jax_default_c2w(), np.float32)[None], (n, 1, 1))
    pose_t = pose_s.copy()
    pose_t[:, 0, 3] += np.linspace(0.0, 0.3, n, dtype=np.float32)
    K = np.tile(np.asarray(jax_intrinsics(30.0, w / 2, h / 2), np.float32)[None], (n, 1, 1))
    return frames, depths, pose_s, pose_t, K, K


def _scene_warp():
    """tests/test_torch_warp.py's scene at 6 frames: a tilted depth plane,
    the camera orbiting away from the anchor."""
    n, h, w = 6, 24, 40
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    yy = np.mgrid[0:h, 0:w][0]
    depths = np.tile((2.0 + 2.0 * yy / h).astype(np.float32), (n, 1, 1))
    depths += 0.05 * rng.standard_normal(depths.shape).astype(np.float32)
    poses = generate_traj_specified(default_c2w(), -8.0, 5.0, -0.2, 0.1, 0.05, n)
    poses[:, 2, 3] += 3.0
    pose_s = poses[:1].repeat(n, 1, 1)
    K = intrinsics_matrix(30.0, w / 2, h / 2)[None].repeat(n, 1, 1)
    return tuple(np.asarray(x, np.float32) for x in (frames, depths, pose_s, poses, K, K))


WARP_CASES = {"multichip": _multichip_warp(), "scene": _scene_warp()}


def _vae_case(h: int, seed: int = 4):
    """tests/test_multichip.py's condition prep and decode inputs at height ``h``."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    video = f32(rng.uniform(0, 1, (1, 5, h, 48, 3)))
    mask = f32((rng.uniform(0, 1, (1, 5, h, 48, 1)) > 0.5) * 255.0)
    ref = f32(rng.uniform(0, 1, (1, 1, h, 48, 3)))
    ref_noise = f32(rng.standard_normal((1, 1, h // 8, 6, 4)))
    aug_noise = f32(rng.standard_normal(video.shape))
    z = f32(rng.standard_normal((1, 2, h // 8, 6, 4)))
    return video, mask, ref, ref_noise, aug_noise, z


# case -> (mesh (dp, sp, tp), inputs)
VAE_CASES = {"dp2_sp2": ((2, 2, 1), *_vae_case(32)),
             "sp2_tp2": ((1, 2, 2), *_vae_case(32)),
             "uneven_dp2_sp2": ((2, 2, 1), *_vae_case(24))}
FAULT_CASE = "dp2_sp2"
GRADUAL_MESH = (2, 2, 1)
# the strip decode: latents, a memory under which both the port's sharded
# twin (its estimate over dp x sp = 4) and JAX's unsharded decode take
# strips, the strip height, the meshes
STRIP_LATENTS = (1, 3, 9, 12, 4)
STRIP_ESTIMATE = 9 * 72 * 96 * 128 * 2 * 3.5  # the one-shot decode's peak estimate
STRIPS = (np.random.default_rng(5).standard_normal(STRIP_LATENTS).astype(np.float32),
          int(STRIP_ESTIMATE / 0.6 / 8), 4, {"dp2_sp2": (2, 2, 1), "sp2_tp2": (1, 2, 2)})


def _gradual_argv(tmp_path):
    return ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
            "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
            "--prompt", "a scene", "--diffusion_inference_steps", "2", "--video_length", "9",
            "--sample_size", "32", "48", "--quant", "none",
            "--model_name", str(tmp_path / "no_checkpoints"),
            "--out_dir", str(tmp_path), "--exp_name", "run"]


@pytest.fixture(scope="module")
def vae_params():
    return jax_tree(AutoencoderKLCogVideoX(**DEV), 0, convert_vae, layers_per_block=1)


@pytest.fixture(scope="module")
def world(vae_params, tmp_path_factory):
    weights = {k: v.numpy() for k, v in vae_from_jax(vae_params).items()}
    gradual_dir = tmp_path_factory.mktemp("gradual_sharded")
    runs = run_world(spatial, WORLD, tmp_path_factory.mktemp("spatial"), WARP_CASES, weights,
                     VAE_CASES, FAULT_CASE, (_gradual_argv(gradual_dir), (48, 80), GRADUAL_MESH),
                     STRIPS)
    return runs, weights


def _unsharded(weights, case):
    """The unsharded port's condition latents and decoded video."""
    from torch_parallel_workers import _vae_pipeline

    video, mask, ref, ref_noise, aug_noise, z = map(T, case)
    pipe = _vae_pipeline(weights, None)
    with torch.no_grad():
        inpaint, ref_lat = pipe.prepare_conditions(video, mask, ref,
                                                   noise_override=(ref_noise, aug_noise))
        return [inpaint.numpy(), ref_lat.numpy(), pipe.decode(z).numpy()]


def _band(shape, mesh, scale):
    """The seam band of a channel-last (B, T, H, W, C) output of ``scale``
    pixels per latent: rows and columns within ``scale`` of a seam."""
    h, w = shape[2:4]
    rows = seam_band(h, shard_sizes(h // scale, mesh[0]), scale, scale)
    cols = seam_band(w, shard_sizes(w // scale, mesh[1]), scale, scale)
    return (rows[:, None] | cols[None, :]).numpy()


def _holds(got, want, band) -> bool:
    return np.allclose(got[:, :, band], want[:, :, band], **SHARD_TOL)


# ----------------------------------------------------------------------------
# the warp
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("clean", [False, True], ids=["plain", "mask_clean"])
@pytest.mark.parametrize("case", WARP_CASES)
def test_sharded_warp_equals_the_unsharded_port(world, case, clean):
    runs, _ = world
    with torch.no_grad():
        want = [x.numpy() for x in forward_warp_batch(*map(T, WARP_CASES[case]),
                                                      use_mask_clean=clean)]
    for run in runs:
        for got, x in zip(run["warp"][case, clean], want):
            assert got.shape == x.shape
            np.testing.assert_array_equal(got, x)
    # each rank splatted its share, 6 frames over 4 ranks, in each of 4 warps
    assert [run["warp_frames"] for run in runs] == [[2] * 4, [2] * 4, [2] * 4, []]
    assert shard_sizes(6, WORLD) == [2, 2, 2, 0]


def test_sharded_warp_holds_to_jax(world):
    runs, _ = world
    case = WARP_CASES["scene"]
    jw, jm, jd, jf = (np.asarray(x) for x in jax_forward_warp_batch(*map(jnp.asarray, case[:5])))
    warped, mask, depth, flow = runs[0]["warp"]["scene", False]
    np.testing.assert_allclose(flow, jf, atol=1e-3, rtol=0)
    assert np.mean(mask != jm) <= MASK_DISAGREE_MAX
    both = (mask > 0) & (jm > 0)
    assert both.mean() > 0.5
    off = (np.abs(warped - jw).max(-1) > 1e-3) | (np.abs(depth - jd) > 1e-3)
    assert off[both].mean() <= KNIFE_EDGE_MAX


# ----------------------------------------------------------------------------
# the condition prep and decode
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", VAE_CASES)
def test_sharded_conditions_and_decode_match_the_unsharded_port(world, case):
    """Every rank's condition latents and decoded video against the
    unsharded port, over the whole tensor and on the seam band; the
    condition latents bit-equal on every rank (the denoise's inputs)."""
    runs, weights = world
    mesh, *inputs = VAE_CASES[case]
    want = _unsharded(weights, inputs)
    for run in runs:
        for name, got, x in zip(OUTPUTS, run[case]["outputs"], want):
            np.testing.assert_allclose(got, x, **SHARD_TOL, err_msg=name)
        for got, first in zip(run[case]["outputs"][:2], runs[0][case]["outputs"][:2]):
            np.testing.assert_array_equal(got, first)


@pytest.mark.parametrize("case", VAE_CASES)
def test_sharded_conditions_and_decode_match_jax(world, vae_params, case):
    runs, _ = world
    _, *inputs = VAE_CASES[case]
    video, mask, ref, ref_noise, aug_noise, z = map(jnp.asarray, inputs)
    vae = JaxVAE(**DEV)
    want = [np.asarray(x) for x in _prepare_conditions_override_jit(
        vae, vae_params, video, mask, ref, ref_noise, aug_noise, 0.0563, True,
        vae.scaling_factor, jnp.float32)]
    want.append(np.asarray(_decode_jit(vae, vae_params, z, vae.scaling_factor)))
    for name, got, x in zip(OUTPUTS, runs[0][case]["outputs"], want):
        assert got.shape == x.shape, name
        np.testing.assert_allclose(got, x, **JAX_TOL, err_msg=name)


@pytest.mark.parametrize("fault", SPATIAL_FAULTS)
def test_planted_faults_fail_on_the_seam_band(world, fault):
    """A zero halo and a slab-local GroupNorm each move every output off
    the unsharded port's on the seam band, where the sound run holds."""
    runs, weights = world
    mesh, *inputs = VAE_CASES[FAULT_CASE]
    want = _unsharded(weights, inputs)
    for run in runs:
        for name, sound, wrong, x in zip(OUTPUTS, run[FAULT_CASE]["outputs"], run[fault], want):
            band = _band(x.shape, mesh, 8 if name == "decoded video" else 1)
            assert band.any() and not band.all()
            assert _holds(sound, x, band), name
            assert not _holds(wrong, x, band), f"{fault} passed on {name}"


@pytest.mark.parametrize("case", VAE_CASES)
def test_every_rank_exchanges_halos_and_norms_and_holds_its_slab(world, case):
    """Halo and GroupNorm traffic on every rank where its axes are split;
    each rank's latent slab and plane as the mesh lays them out."""
    runs, _ = world
    (dp, sp, tp), *inputs = VAE_CASES[case]
    h, w = inputs[-1].shape[2:4]
    for run in runs:
        got = run[case]
        i, j, k = got["coords"]
        assert got["latent_slab"] == (shard_sizes(h, dp)[i], shard_sizes(w, sp)[j])
        assert got["plane"] == tuple(a * sp * tp + b * tp + k for a in range(dp)
                                     for b in range(sp))
        assert got["transport"]["halo direct"] > 0 and got["transport"]["norm direct"] > 0
        assert got["transport"]["slabs direct bytes"] > 0


def test_the_uneven_split_gives_the_last_dp_rank_fewer_rows(world):
    runs, _ = world
    assert sorted({run["uneven_dp2_sp2"]["latent_slab"] for run in runs}) == [(1, 3), (2, 3)]


# ----------------------------------------------------------------------------
# infer_gradual
# ----------------------------------------------------------------------------


def test_sharded_infer_gradual_matches_its_unsharded_twin(world, tmp_path):
    """``infer_gradual`` of the dev stack under dp 2 x sp 2: the leader's
    video against the unsharded run's, every other rank's equal to the
    leader's; every rank warped its share of the 9 frames, exchanged halos
    and norms and ran the depth stage (here the plane-depth stand-in); only
    the leader encodes the prompt and writes."""
    runs, _ = world
    cfg = cli.parse_config(_gradual_argv(tmp_path))
    cfg.warp_size = (48, 80)
    want = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu")).infer_gradual()
    lead = runs[0]["gradual"]
    assert lead["gen"].shape == want.shape == (9, 32, 48, 3)
    assert np.abs(lead["gen"] - want).max() <= 1.0 / 255.0 + 1e-6
    for run in runs[1:]:  # every rank gets the video back
        np.testing.assert_array_equal(run["gradual"]["gen"], lead["gen"])
    assert [run["gradual"]["warp_frames"] for run in runs] == [[n] if n else []
                                                               for n in shard_sizes(9, WORLD)]
    for run in runs:
        transport = run["gradual"]["transport"]
        assert transport["halo direct"] > 0 and transport["norm direct"] > 0
        assert transport["warp direct"] == 1
        assert {"handoff", "depth"} <= set(run["gradual"]["stages"])
    assert {"prompt_encode", "write_mp4"} <= set(lead["stages"])
    assert not {"prompt_encode", "write_mp4"} & set(runs[1]["gradual"]["stages"])


# ----------------------------------------------------------------------------
# the sharded strip decode
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", STRIPS[3])
def test_sharded_strip_decode_matches_the_unsharded_strips(world, mesh):
    """Under a memory that forces strips every rank decodes the same three
    strips of 4, 4 and 3 latent rows on its plane and blends them as the
    unsharded decode does: its video within the sharded tolerance of the
    unsharded strip decode's, and off the one-shot decode's."""
    runs, weights = world
    from torch_parallel_workers import _vae_pipeline

    z, memory, strip_height, _ = STRIPS
    vae = _vae_pipeline(weights, None).vae
    with torch.no_grad():
        assert decode_is_tiled(STRIP_LATENTS, memory) and decode_is_tiled(STRIP_LATENTS, memory, 4)
        want = vae_decode_auto(vae, T(z), memory, strip_height).numpy()
        one_shot = vae_decode(vae, T(z)).numpy()
    for run in runs:
        got = run[f"strips {mesh}"]
        assert got["tiles"] == [(4, 12), (4, 12), (3, 12)]
        np.testing.assert_allclose(got["video"], want, **SHARD_TOL)
        assert not np.allclose(got["video"], one_shot, **SHARD_TOL)
        np.testing.assert_array_equal(got["video"], runs[0][f"strips {mesh}"]["video"])


@pytest.mark.parametrize("mesh", STRIPS[3])
def test_sharded_strip_decode_matches_jax(world, vae_params, mesh, monkeypatch):
    """JAX's ``vae_decode_auto`` on the same weights, given the same memory
    (``device_hbm_bytes`` patched) and strip height: its strips against the
    sharded twin's."""
    from trajectorycrafter_tpu.utils import offload

    runs, _ = world
    z, memory, strip_height, _ = STRIPS
    monkeypatch.setattr(offload, "device_hbm_bytes", lambda: memory)
    want = np.asarray(jax_vae_decode_auto(JaxVAE(**DEV), vae_params, jnp.asarray(z),
                                          strip_height=strip_height))
    got = runs[0][f"strips {mesh}"]["video"]
    assert got.shape == want.shape == (1, 9, 72, 96, 3)
    np.testing.assert_allclose(got, want, **JAX_TOL)


# ----------------------------------------------------------------------------
# the plane's rules, without a world
# ----------------------------------------------------------------------------


def _plane(dp: int, sp: int, i: int = 0, j: int = 0) -> Plane:
    axis = lambda name, n, k: D.Axis(name, n, k, tuple(range(n)))
    return Plane(axis("dp", dp, i), axis("sp", sp, j), axis("plane", dp * sp, i * sp + j))


def test_decode_auto_divides_by_the_plane_and_refuses_strips():
    """The sharded decode's estimate is a rank's: the one-shot peak over dp
    x sp (not the mesh size the JAX package divides by: tp ranks hold the
    same slab).  Where a rank's slab needs strips, the strips run on the
    twin (here a one-rank plane, which needs no world: the 4-rank planes
    run in the world above) and match the unsharded strip decode; a strip
    that would leave a rank without latent rows is refused, naming the
    split, before anything runs."""
    vae = AutoencoderKLCogVideoX(**DEV)
    twin = shard_spatially(vae, _plane(2, 2))
    assert decode_peak_divisor(vae) == 1 and decode_peak_divisor(twin) == 4
    assert twin.decoder.conv_in.plane is twin.plane and vae.decoder.conv_in.plane is None
    assert twin.decoder.conv_in.conv.weight is vae.decoder.conv_in.conv.weight
    shape = (1, 13, 72, 128, 16)
    peak = 1 * 49 * 576 * 1024 * 128 * 2 * 3.5  # the whole one-shot decode's estimate
    memory = int(peak / 3 / 0.60)
    assert decode_is_tiled(shape, memory) and not decode_is_tiled(shape, memory, 4)
    assert decode_is_tiled(shape, memory, 2)  # a tp-sized divisor would not be enough

    torch.manual_seed(0)
    for p in vae.parameters():
        p.data.normal_(0.0, 0.2)
    z = T(STRIPS[0])
    one = shard_spatially(vae, _plane(1, 1))
    with torch.no_grad():
        got = vae_decode_auto(one, z, STRIPS[1], STRIPS[2])
        want = vae_decode_tiled(vae, z, STRIPS[2], z.shape[3], 1.0 / 7.0, 0.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SHARD_TOL)
        assert not np.allclose(got.numpy(), vae_decode(vae, z).numpy(), **SHARD_TOL)
    # 41 latent rows: strips at rows 0, 20 and 40, the last of one row
    with pytest.raises(ValueError, match="1 x 128 latents leave a rank of the dp 2"):
        vae_decode_auto(twin, torch.zeros(1, 13, 41, 128, 16), int(peak / 8 / 0.60))


def test_the_plane_splits_in_whole_latent_rows_or_raises():
    x = torch.arange(24 * 48).reshape(1, 24, 48).float()
    parts = [_plane(2, 2, i, j).slab(x, 8) for i in range(2) for j in range(2)]
    assert [tuple(p.shape[1:]) for p in parts] == [(16, 24), (16, 24), (8, 24), (8, 24)]
    assert torch.equal(parts[3], x[:, 16:, 24:])
    with pytest.raises(ValueError, match="whole latent rows"):
        _plane(2, 1).slab(torch.zeros(1, 20, 48), 8)
    with pytest.raises(ValueError, match="without rows or columns"):
        _plane(4, 1).slab(torch.zeros(1, 24, 48), 8)
    band = seam_band(24, [2, 1], 8, 4).numpy()
    assert band.nonzero()[0].tolist() == list(range(12, 20))
