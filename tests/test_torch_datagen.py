"""Port training-data generation (trajectorycrafter_tpu_torch/datagen.py) vs
the JAX package's datagen.py.

The dataset readers run on SceneFlow- and TartanAir-layout files the test
writes (PNG frames, PFM disparities little- and big-endian, camera_data.txt,
depth .npy, NED pose lines, the TartanAir list file) and must return what
the JAX readers return, exactly.  The motion filter and the clip tuples are
exact too.

``smart_resize`` agrees to 1e-5 (bilinear sums in another order).
``encode_sample`` runs the dev VAE of tests/test_torch_vae.py (the same
seeded weights through ``vae_from_jax``) at 9 frames: 1e-4 absolute and
relative, as there.  ``generate_pair_from_depth`` is the forward-splat warp,
held to tests/test_torch_warp.py's bounds: hole masks disagree on at most
0.5% of the pixels, and at most 3% of the pixels both sides know may differ
by more than 1e-3 (knife edges).  ``generate_dataset`` end to end: the
ground-truth and reference latents and the prompt to 1e-4, the inpaint
latents (which carry the warp's knife edges through the encoder) to a
relative L2 error of 2e-2.
"""

import numpy as np
import pytest
import torch
from torch_parity import jax_tree

import trajectorycrafter_tpu.datagen as jdg
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.utils.convert import convert_vae
from trajectorycrafter_tpu_torch import datagen as tdg
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.utils.weights import vae_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
MASK_DISAGREE_MAX = 0.005
KNIFE_EDGE_MAX = 0.03
DEV = dict(latent_channels=4, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
           norm_num_groups=4)
SRC_HW = (40, 72)  # the written clips' frames (h, w)
SAMPLE = (32, 48)
FRAMES = 9


@pytest.fixture(scope="module")
def vae_pair():
    params = jax_tree(AutoencoderKLCogVideoX(**DEV), 0, convert_vae, layers_per_block=1)
    tmodel = AutoencoderKLCogVideoX(**DEV)
    tmodel.load_state_dict(vae_from_jax(params), strict=True)
    return JaxVAE(**DEV), params, tmodel.eval()


# ----------------------------------------------------------------------------
# files in the datasets' layouts
# ----------------------------------------------------------------------------


def write_pfm(path, img, big_endian=False, comment=False):
    img = np.asarray(img, np.float32)
    header = b"PF\n" if img.ndim == 3 else b"Pf\n"
    h, w = img.shape[:2]
    data = np.flipud(img).astype(">f4" if big_endian else "<f4")
    with open(path, "wb") as f:
        f.write(header + (b"# made by the test\n" if comment else b"")
                + f"{w} {h}\n".encode() + (b"1.0\n" if big_endian else b"-1.0\n")
                + data.tobytes())


def _smooth_frames(rng, n, h, w):
    """Frames with structure at several scales (a warp of noise is all
    knife edges), in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    base = np.stack([np.sin(6 * xx + 2 * yy), np.cos(5 * yy - 3 * xx), np.sin(9 * xx * yy)], -1)
    frames = [(0.5 + 0.4 * base * np.cos(0.3 * i + np.arange(3)) + 0.05
               * rng.standard_normal((h, w, 3))) for i in range(n)]
    return np.clip(np.stack(frames), 0, 1)


def write_sceneflow(root, scene, n=FRAMES, seed=0, step=0.15):
    """<root>/frames_cleanpass/<scene>/left/NNNN.png, disparity/<scene>/left/
    NNNN.pfm and camera_data/<scene>/camera_data.txt (c2w moving along x)."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = SRC_HW
    frames = _smooth_frames(rng, n, h, w)
    (root / "frames_cleanpass" / scene / "left").mkdir(parents=True)
    (root / "disparity" / scene / "left").mkdir(parents=True)
    (root / "camera_data" / scene).mkdir(parents=True)
    lines = []
    for i in range(n):
        rgb = (frames[i] * 255).round().astype(np.uint8)
        cv2.imwrite(str(root / "frames_cleanpass" / scene / "left" / f"{i:04d}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        disp = 20.0 + 10.0 * np.mgrid[0:h, 0:w][0] / h + rng.uniform(0, 0.5, (h, w))
        write_pfm(root / "disparity" / scene / "left" / f"{i:04d}.pfm", disp,
                  big_endian=i % 2 == 1, comment=i == 0)
        c2w = np.eye(4)
        c2w[0, 3] = step * i
        c2w[:3, :3] = _yaw(0.01 * i)
        right = c2w.copy()
        right[0, 3] += 1.0  # the stereo baseline
        lines += [f"Frame {i}", "L " + " ".join(f"{v:.9g}" for v in c2w.flatten()),
                  "R " + " ".join(f"{v:.9g}" for v in right.flatten()), ""]
    (root / "camera_data" / scene / "camera_data.txt").write_text("\n".join(lines))


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


# ----------------------------------------------------------------------------
# readers
# ----------------------------------------------------------------------------


def test_read_pfm_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    cases = {"le1.pfm": (rng.standard_normal((5, 7)), False, False),
             "be1.pfm": (rng.standard_normal((5, 7)), True, True),
             "le3.pfm": (rng.standard_normal((4, 6, 3)), False, True)}
    for name, (img, big, comment) in cases.items():
        write_pfm(tmp_path / name, img, big, comment)
        got, want = tdg.read_pfm(str(tmp_path / name)), jdg.read_pfm(str(tmp_path / name))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img.astype(np.float32))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError, match="not a PFM"):
        tdg.read_pfm(str(tmp_path / "bad.pfm"))
    np.testing.assert_array_equal(tdg.disparity_to_depth(np.array([2.0, 0.0, -4.0])),
                                  jdg.disparity_to_depth(np.array([2.0, 0.0, -4.0])))


def test_sceneflow_reader_matches_jax(tmp_path):
    write_sceneflow(tmp_path, "scene_a")
    path = str(tmp_path / "camera_data" / "scene_a" / "camera_data.txt")
    got_cam, want_cam = tdg.read_sceneflow_camera_data(path), jdg.read_sceneflow_camera_data(path)
    assert got_cam.keys() == want_cam.keys() == set(range(FRAMES))
    for i in want_cam:
        for side in "LR":
            np.testing.assert_array_equal(got_cam[i][side], want_cam[i][side])
    for ids in (None, [2, 5, 7]):
        got = tdg.load_sceneflow_clip(str(tmp_path), "scene_a", frame_ids=ids)
        want = jdg.load_sceneflow_clip(str(tmp_path), "scene_a", frame_ids=ids)
        assert got.keys() == want.keys() and got["frame_ids"] == want["frame_ids"]
        for key in ("frames", "depths", "poses", "K"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    bad = tmp_path / "bad.txt"
    bad.write_text("Frame 0\nL 1 2 3\n")
    with pytest.raises(ValueError, match="expected 16"):
        tdg.read_sceneflow_camera_data(str(bad))


def test_tartanair_reader_matches_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(2)
    seq = tmp_path / "abandonedfactory" / "Easy" / "P000"
    (seq / "image_left").mkdir(parents=True)
    (seq / "depth_left").mkdir(parents=True)
    poses = []
    for i in range(6):
        img = (rng.uniform(0, 255, (12, 16, 3))).astype(np.uint8)
        cv2.imwrite(str(seq / "image_left" / f"{i:06d}_left.png"), img)
        np.save(seq / "depth_left" / f"{i:06d}_left_depth.npy",
                rng.uniform(1, 10, (12, 16)).astype(np.float32))
        q = rng.standard_normal(4)
        poses.append([0.1 * i, -0.05 * i, 0.02 * i, *(q / np.linalg.norm(q))])
    np.savetxt(seq / "pose_left.txt", np.array(poses))
    listing = tmp_path / "ta_datafile.txt"
    listing.write_text("abandonedfactory/Easy/P000 3\n1\n3\n4\n\nother/P001 1\n0\n")
    got, want = tdg.parse_ta_datafile(str(listing)), jdg.parse_ta_datafile(str(listing))
    assert got == want == [("abandonedfactory/Easy/P000", [1, 3, 4]), ("other/P001", [0])]
    listing.write_text("seq 3\n1\n")
    with pytest.raises(ValueError, match="truncated"):
        tdg.parse_ta_datafile(str(listing))
    for pose in poses:
        np.testing.assert_array_equal(tdg.tartanair_pose_to_w2c(pose),
                                      jdg.tartanair_pose_to_w2c(pose))
    got = tdg.load_tartanair_clip(str(tmp_path), "abandonedfactory/Easy/P000", [1, 3, 4])
    want = jdg.load_tartanair_clip(str(tmp_path), "abandonedfactory/Easy/P000", [1, 3, 4])
    for key in ("frames", "depths", "poses", "K"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_motion_filter_and_clips_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    clips = []
    for i, scale in enumerate((0.5, 3.0, 40.0)):
        poses = np.tile(np.eye(4), (12, 1, 1))
        poses[:, 0, 3] = np.cumsum(rng.uniform(0, scale, 12))
        poses[:, :3, :3] = np.stack([_yaw(0.01 * k * (i + 1)) for k in range(12)])
        clips.append({"frames": rng.uniform(0, 1, (12, 4, 6, 3)).astype(np.float32),
                      "depths": rng.uniform(1, 5, (12, 4, 6)).astype(np.float32),
                      "poses": poses, "K": np.eye(3)})
    for clip in clips:
        assert tdg.motion_metrics(clip["poses"]) == jdg.motion_metrics(clip["poses"])
        assert tdg.is_low_motion(clip["poses"]) == jdg.is_low_motion(clip["poses"])
    for kw in ({}, {"motion_filter": False, "anchor": 20}, {"max_total_translation": 5.0}):
        got = list(tdg.clips_from_dataset(iter(clips), **kw))
        want = list(jdg.clips_from_dataset(iter(clips), **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert len(list(tdg.clips_from_dataset(iter(clips)))) < len(clips)


# ----------------------------------------------------------------------------
# resize, warp, encode
# ----------------------------------------------------------------------------


def test_smart_resize_matches_jax():
    frames = np.random.default_rng(4).uniform(0, 1, (3, 40, 72, 3)).astype(np.float32)
    for out_hw in (SAMPLE, (24, 24), (48, 96)):
        got, want = tdg.smart_resize(frames, out_hw), jdg.smart_resize(frames, out_hw)
        assert got.shape == (3, *out_hw, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _warp_inputs(seed=5):
    rng = np.random.default_rng(seed)
    n, (h, w) = 3, SRC_HW
    frames = _smooth_frames(rng, n, h, w).astype(np.float32)
    depths = np.tile((2.0 + 2.0 * np.mgrid[0:h, 0:w][0] / h).astype(np.float32), (n, 1, 1))
    pose_s = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pose_t = pose_s.copy()
    pose_t[:, 0, 3] = [0.05, 0.1, 0.15]
    pose_t[:, :3, :3] = np.stack([_yaw(0.02 * (i + 1)) for i in range(n)])
    K = np.tile(np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32), (n, 1, 1))
    return frames, depths, pose_s, pose_t, K


def test_generate_pair_from_depth_matches_jax():
    args = _warp_inputs()
    warped, mask = tdg.generate_pair_from_depth(*args)
    jwarped, jmask = jdg.generate_pair_from_depth(*args)
    assert warped.shape == args[0].shape and mask.shape == args[1].shape
    assert np.mean(mask != jmask) <= MASK_DISAGREE_MAX
    both = (mask > 0) & (jmask > 0)
    assert both.mean() > 0.5
    off = np.abs(warped - jwarped).max(-1) > 1e-3
    assert off[both].mean() <= KNIFE_EDGE_MAX
    assert warped.min() >= 0 and warped.max() <= 1
    assert np.all(warped[mask == 0] == 0.0)


def test_encode_sample_matches_jax(vae_pair):
    jmodel, params, tmodel = vae_pair
    rng = np.random.default_rng(6)
    gt = rng.uniform(0, 1, (FRAMES, *SAMPLE, 3)).astype(np.float32)
    warped = rng.uniform(0, 1, (FRAMES, *SAMPLE, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (FRAMES, *SAMPLE)) > 0.3).astype(np.float32)
    prompt = rng.standard_normal((5, 8)).astype(np.float32)
    for ref in (None, gt[:5]):
        want = jdg.encode_sample(jmodel, params, gt, warped, masks, prompt, ref)
        got = tdg.encode_sample(tmodel, gt, warped, masks, prompt, ref)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].shape == want[key].shape and got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert got["inpaint_latents"].shape == (3, 4, 6, 5)


def test_generate_dataset_end_to_end_matches_jax(vae_pair, tmp_path):
    """Two SceneFlow clips through the readers, the anchor warp and the
    encode into .npz samples, on both sides."""
    jmodel, params, tmodel = vae_pair
    for i, scene in enumerate(("scene_a", "scene_b")):
        write_sceneflow(tmp_path / "sf", scene, seed=10 + i, step=0.05 * (i + 1))
    prompt = np.random.default_rng(7).standard_normal((5, 8)).astype(np.float32)
    clip_dicts = lambda loader: (loader(str(tmp_path / "sf"), s, focal=60.0)
                                 for s in ("scene_a", "scene_b"))
    got_dir = tdg.generate_dataset(
        tmodel, str(tmp_path / "port"),
        tdg.clips_from_dataset(clip_dicts(tdg.load_sceneflow_clip), anchor=4,
                               motion_filter=False), prompt, sample_size=SAMPLE)
    want_dir = jdg.generate_dataset(
        jmodel, params, str(tmp_path / "jax"),
        jdg.clips_from_dataset(clip_dicts(jdg.load_sceneflow_clip), anchor=4,
                               motion_filter=False), prompt, sample_size=SAMPLE)
    names = ["sample_000000.npz", "sample_000001.npz"]
    for name in names:
        with np.load(f"{got_dir}/{name}") as g, np.load(f"{want_dir}/{name}") as w:
            assert sorted(g.files) == sorted(w.files) == sorted(
                ["gt_latents", "ref_latents", "inpaint_latents", "prompt_embeds"])
            for key in ("gt_latents", "ref_latents", "prompt_embeds"):
                np.testing.assert_allclose(g[key], w[key], **TOL, err_msg=key)
            inpaint, want = g["inpaint_latents"], w["inpaint_latents"]
            assert inpaint.shape == want.shape == (3, 4, 6, 5)
            rel = np.linalg.norm(inpaint - want) / np.linalg.norm(want)
            assert rel <= 2e-2, rel
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset

    assert [s.split("/")[-1] for s in LatentsDataset(got_dir).files] == names
