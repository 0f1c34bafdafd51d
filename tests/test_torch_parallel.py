"""The port's sharded denoise (trajectorycrafter_tpu_torch/parallel/,
``models/dit.py`` under a mesh, ``pipelines/trajcrafter.py with_mesh``, the
CLI's mesh flags) vs the JAX package, on the CPU.

The sharded runs are real multi-process gloo worlds (tests/torch_worlds.py:
ranks started by ``file://`` under the test's tmp_path, joined with a
timeout; tests/torch_parallel_workers.py holds the ranks' side); a mesh
smaller than the world leaves the other ranks idle.  The model is the tiny
DiT of 4 heads x 16, 2 layers, a Perceiver of 4 heads, weights drawn with
numpy from a seed (tests/torch_parity.py), fp32 on both sides: "bf16" of
the card is the unquantized model here, which the card runs in bf16.

Tolerances, with their reasons:
  * the mesh's rank coordinates, the tp shards of every DiT tensor, the
    row-parallel int8 codes and scales, ``build_dit``'s shards: bit-equal.
    The row-parallel layer reduces its rows' max |x| over tp before it
    quantizes, as XLA keeps the JAX layer's max over all input features;
    each rank's own max (the planted fault) changes codes.
  * the sharded forward, unquantized: 2e-5 absolute and relative against
    the JAX unsharded forward, as tests/test_torch_dit.py holds the
    unsharded one: the ring's logsumexp merges and the tp partial sums take
    fp32 sums in another order (~1e-7 at O(1) outputs).
  * the sharded forward, int8: 2^-6 of the output's largest magnitude.  The
    same reordered fp32 sums move an activation by ~1e-7; where it sits that
    close to a code's rounding boundary, its int8 code flips, which moves
    its row by one quantization step (1/127 of the row's largest value) and
    spreads through the next blocks' attention (3.0e-3 at sp 2, none at sp
    4 or tp 4 on these inputs).  The codes themselves are held bit-equal
    above.
  * the fused int8 feed-forward under tp 2: 1e-5 of its largest magnitude
    against the unsharded fused chain (the same codes; partial sums in
    fp32).
  * the 2-step denoise under dp2 x sp2 against the unsharded port: 1e-4
    absolute and relative, as tests/test_torch_pipeline.py holds the
    pipeline; every rank's latents bit-equal after every step.
"""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parallel_workers import denoise, dit_forwards, row_parallel
from torch_parity import fill_from_numpy_, jax_tree
from torch_worlds import run_world

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.ops import int8 as jax_int8
from trajectorycrafter_tpu.ops.pallas import int8_matmul as jax_mm
from trajectorycrafter_tpu.parallel import dit_param_sharding
from trajectorycrafter_tpu.parallel import make_mesh as jax_make_mesh
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch import cli, orchestrator
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel, FeedForward
from trajectorycrafter_tpu_torch.ops import int8_matmul as im
from trajectorycrafter_tpu_torch.ops.int8 import quantize_dit_
from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
from trajectorycrafter_tpu_torch.orchestrator import build_dev_models, build_dit, random_init_
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.mesh import mesh_ranks
from trajectorycrafter_tpu_torch.parallel.sharding import layer_rule, shard_sizes
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax

torch.set_num_threads(1)
T = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]
CLIP = str(REPO / "test/videos/synth.mp4")
TRAJ = str(REPO / "test/trajs/loop1.txt")
WORLD = 8
DIMS = dict(num_attention_heads=4, attention_head_dim=16, in_channels=9, out_channels=4,
            time_embed_dim=16, text_embed_dim=32, num_layers=2, sample_width=12,
            sample_height=8, sample_frames=9, max_text_seq_length=7, cross_attn_dim_head=8,
            cross_attn_num_heads=4)
TEXT_LEN = 7
MESHES = [(2, 2, 2), (1, 4, 1), (1, 1, 4), (2, 1, 1)]
MESH_IDS = ["dp2_sp2_tp2", "sp4", "tp4", "dp2"]
EXACT_TOL = dict(atol=2e-5, rtol=2e-5)
INT8_TOL = 2.0 ** -6


@pytest.fixture(scope="module")
def params():
    p = jax_tree(CrossTransformer3DModel(**DIMS), 0, convert_dit, num_layers=2)
    return {"none": p, "int8": jax.tree.map(np.asarray, jax_int8.quantize_dit_params(p))}


def _inputs():
    rng = np.random.default_rng(1)
    b, f, h, w = 2, 3, 8, 12
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)
    # the CFG pair at two timesteps, so that a batch row on the wrong dp rank shows
    return (normal(b, f, h, w, 4), normal(b, TEXT_LEN, 32), np.asarray([311.0, 511.0], np.float32),
            normal(b, f, h, w, 5), normal(b, 2, h, w, 4))


@pytest.fixture(scope="module")
def forwards(params, tmp_path_factory):
    """Every mesh's sharded forwards (unquantized, int8) in one world of 8,
    and the JAX unsharded forwards."""
    args, rope = _inputs(), rope_for_sample(16, 64, 96, 3)
    models = {"none": (params["none"], False), "int8": (params["int8"], True)}
    runs = run_world(dit_forwards, WORLD, tmp_path_factory.mktemp("dit"), MESHES, models,
                     DIMS, args, rope)
    want = {}
    for name, quant in (("none", "none"), ("int8", "int8")):
        model = JaxDiT(**DIMS, quant=quant, attention_impl="xla")
        want[name] = np.asarray(jax.jit(model.apply)(
            {"params": params[name]}, *map(jnp.asarray, args),
            image_rotary_emb=tuple(map(jnp.asarray, rope))))
    return runs, want, args, rope


# ----------------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (2, 1, 4)], ids=str)
def test_make_mesh_places_ranks_as_jax_places_devices(shape):
    want = np.vectorize(lambda d: d.id)(jax_make_mesh(*shape).devices)
    got = mesh_ranks(*shape, world_size=WORLD)
    assert got.shape == want.shape == (*shape, 1)
    np.testing.assert_array_equal(got, want)


def test_make_mesh_raises_and_warns_as_jax():
    for make in (lambda: jax_make_mesh(2, 2, 4), lambda: mesh_ranks(2, 2, 4, world_size=8)):
        with pytest.raises(ValueError, match="exceeds 8"):
            make()
    for make in (lambda: jax_make_mesh(1, 2, 2), lambda: mesh_ranks(1, 2, 2, world_size=8)):
        with pytest.warns(UserWarning, match="uses 4 of 8"):
            make()
    for make in (lambda: jax_make_mesh(1, 1, 2, 3), lambda: mesh_ranks(1, 1, 2, 3, world_size=8)):
        with pytest.warns(UserWarning, match="uses 6 of 8"):
            make()


# ----------------------------------------------------------------------------
# the tensor-parallel layout
# ----------------------------------------------------------------------------


def _jax_rank_tree(sharded, mesh, tp_rank):
    """Each leaf's data on the devices at tp coordinate ``tp_rank``."""
    tp_of = {d.id: int(np.argwhere(mesh.devices == d)[0][2]) for d in mesh.devices.flat}

    def pick(leaf):
        datas = [np.asarray(s.data) for s in leaf.addressable_shards
                 if tp_of[s.device.id] == tp_rank]
        assert all(np.array_equal(datas[0], x) for x in datas)  # replicated along dp
        return datas[0]

    return jax.tree.map(pick, sharded)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp_shards_match_jax_dit_param_sharding(params, quant):
    """Rank r's shard of every DiT tensor against the shard JAX's
    ``dit_param_sharding`` places on the devices at tp coordinate r of the
    (2, 1, 4) CPU mesh.  Two storage layouts differ, by design: JAX keeps
    the 1-D biases of column-parallel layers whole (the port takes its
    columns' part of them), and splits the Perceiver's packed to_kv into
    contiguous column ranges (the port takes its heads of k and of v)."""
    tree, tp = params[quant], 4
    mesh = jax_make_mesh(2, 1, tp)
    sharded = jax.device_put(tree, dit_param_sharding(tree, mesh))
    whole = dit_from_jax(tree)
    seen = set()
    for r in range(tp):
        jax_r = dit_from_jax(_jax_rank_tree(sharded, mesh, r))
        got = dit_from_jax(tree, tp, r)
        assert set(got) == set(jax_r) == set(whole)
        for key, x in got.items():
            rule, param = layer_rule(key), key.rsplit(".", 1)[1]
            seen.add((rule, param))
            if rule == "kv":
                k, v = (np.split(half, tp)[r] for half in np.split(whole[key].numpy(), 2))
                want = np.concatenate([k, v])
            elif rule == "col" and param == "bias":
                assert jax_r[key].shape == whole[key].shape
                want = np.split(jax_r[key].numpy(), tp)[r]
            else:
                want = jax_r[key].numpy()
            assert x.dtype == jax_r[key].dtype and np.array_equal(x.numpy(), want), key
    expected = {("row", "weight"), ("col", "weight"), ("col", "bias"), ("kv", "weight"),
                (None, "weight"), (None, "bias"), ("row", "bias")}
    if quant == "int8":
        expected = {(r, "weight_q" if p == "weight" and r else p) for r, p in expected}
        expected |= {("col", "weight_scale"), ("row", "weight_scale"), ("kv", "weight_scale"),
                     (None, "weight")}
    assert expected <= seen


def test_build_dit_draws_the_weights_of_random_init():
    """``build_dit`` allocates the DiT a module at a time and draws the
    weights ``random_init_`` draws over the whole model, bit for bit; its
    int8 build is ``quantize_dit_`` of them."""
    make = lambda: CrossTransformer3DModel(**DIMS)
    for quant in ("none", "int8"):
        want = random_init_(make(), 3)
        if quant == "int8":
            quantize_dit_(want)
        got = build_dit(make, "cpu", torch.float32, 3, quant).state_dict()
        assert set(got) == set(want.state_dict())
        assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())


# ----------------------------------------------------------------------------
# the row-parallel int8 layer
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def row_parallel_runs(tmp_path_factory):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((37, 64)) * rng.uniform(0.1, 3.0, (37, 1))).astype(np.float32)
    x[5] = 0.0  # a row of zeros takes the 1e-8 floor
    ff = FeedForward(512)  # FF width 2,048: one 1,024-column group per rank at tp 2
    fill_from_numpy_(ff, 6)
    ff_x = rng.standard_normal((2, 9, 512)).astype(np.float32)
    weights = {k: v.numpy() for k, v in ff.state_dict().items()}
    runs = run_world(row_parallel, 4, tmp_path_factory.mktemp("rows"), x, weights, ff_x)
    return x, weights, ff_x, runs


@pytest.mark.parametrize("tp", [2, 4])
def test_row_parallel_int8_quantization_is_bit_equal(row_parallel_runs, tp):
    """Each rank's codes and scales of its columns are the unsharded
    layer's, the port's and the JAX package's, bit for bit."""
    x, _, _, runs = row_parallel_runs
    xq, xs = im.quantize_rows(T(x))
    jq, js = (np.asarray(a) for a in jax_mm.quantize_rows(jnp.asarray(x)))
    np.testing.assert_array_equal(xq.numpy(), jq)
    faulty = False
    for run in runs:
        r, codes, scales, codes_own_max = run[tp]
        cols = np.split(np.arange(x.shape[1]), tp)[r]
        np.testing.assert_array_equal(codes, xq.numpy()[:, cols])
        np.testing.assert_array_equal(scales, xs.numpy())
        faulty |= not np.array_equal(codes_own_max, xq.numpy()[:, cols])
    assert faulty  # a rank's own row max quantizes other codes


def test_fused_int8_ff_under_tp_matches_unsharded(row_parallel_runs):
    """The fused int8 FF (K3a / K3b's route) under tp 2, where each rank's
    columns hold whole quantization groups, against the unsharded fused
    chain; a tp that splits a group raises."""
    from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_linear

    _, weights, ff_x, runs = row_parallel_runs
    ff = FeedForward(512)
    ff.load_state_dict({k: T(v) for k, v in weights.items()})
    ff.net[0].proj = Int8Linear.from_linear(ff.net[0].proj)
    ff.net[2] = Int8Linear.from_linear(ff.net[2])
    ff.fuse = True
    with torch.no_grad():
        want = ff(T(ff_x)).numpy()
    for run in runs:
        assert np.abs(run["ff"] - want).max() <= 1e-5 * np.abs(want).max()
    axis = D.Axis("tp", 4, 0, (0, 1, 2, 3))  # 2,048 / 4 = 512 columns: half a group
    ff.net[0].proj = shard_linear(ff.net[0].proj, "col", axis)
    ff.net[2] = shard_linear(ff.net[2], "row", axis)
    with pytest.raises(ValueError, match="multiple of its 1024-column group"):
        ff(T(ff_x))


# ----------------------------------------------------------------------------
# the sharded DiT forward
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharded_dit_matches_jax(forwards, shape, quant):
    runs, want, _, _ = forwards
    outs = [run[shape, quant] for run in runs if (shape, quant) in run]
    assert len(outs) == int(np.prod(shape))
    for o in outs:
        assert o["heads"] == (4 // shape[2], 4 // shape[2])
        if quant == "none":
            np.testing.assert_allclose(o["out"], want[quant], **EXACT_TOL)
        else:
            assert np.abs(o["out"] - want[quant]).max() <= INT8_TOL * np.abs(want[quant]).max()
    assert all(run[shape, "build_dit"] for run in runs if (shape, "build_dit") in run)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 1)], ids=["dp2_sp2_tp2", "sp4"])
def test_text_rows_are_computed_once_across_sp(forwards, params, shape):
    """The joint [text; video] sequence is split over sp as JAX's shard_map
    splits it, so each text row is computed by one sp rank only (no two
    ranks can disagree on it), and the rows, joined in sp order, are the
    unsharded model's text stream after the last block."""
    runs, _, args, rope = forwards
    model = CrossTransformer3DModel(**DIMS)
    model.load_state_dict(dit_from_jax(params["none"]), strict=True)
    text = []
    model.transformer_blocks[-1].register_forward_hook(lambda m, i, o: text.append(o[1]))
    with torch.no_grad():
        model.eval()(*map(T, args), image_rotary_emb=tuple(map(T, rope)))
    sp = shape[1]
    sizes = shard_sizes(TEXT_LEN + 3 * 4 * 6, sp)
    for dp in range(shape[0]):
        for tp in range(shape[2]):
            held = {o["coords"][1]: o["text_rows"] for run in runs
                    for o in [run.get((shape, "none"))]
                    if o is not None and o["coords"][0] == dp and o["coords"][2] == tp}
            counts = [held[j].shape[1] for j in range(sp)]
            assert counts == [max(0, min(n, TEXT_LEN - sum(sizes[:j])))
                              for j, n in enumerate(sizes)]
            joined = np.concatenate([held[j] for j in range(sp)], axis=1)
            rows = slice(dp * 2 // shape[0], (dp + 1) * 2 // shape[0])
            np.testing.assert_allclose(joined, text[0][rows].numpy(), **EXACT_TOL)


# ----------------------------------------------------------------------------
# the sharded denoise
# ----------------------------------------------------------------------------


def _pipe_args():
    rng = np.random.default_rng(8)
    f32 = lambda x: np.asarray(x, np.float32)
    return (f32(rng.standard_normal((1, 16, 64))), f32(rng.standard_normal((1, 16, 64))),
            f32(rng.uniform(0, 1, (1, 9, 32, 48, 3))),
            f32((rng.uniform(size=(1, 9, 32, 48, 1)) > 0.7) * 255.0),
            f32(rng.uniform(0, 1, (1, 2, 32, 48, 3))))


# case -> (sampler, the leader's sampling arguments); each runs 2 loop steps
DENOISE_CASES = {
    "DDIM_Origin": ("DDIM_Origin", dict(num_inference_steps=2)),
    "Euler A": ("Euler A", dict(num_inference_steps=2)),
    "DDIM_Origin strength 0.5, dynamic CFG": ("DDIM_Origin", dict(
        num_inference_steps=4, strength=0.5, guidance_scale=3.0, use_dynamic_cfg=True)),
}
DENOISE_SEED = 2


@pytest.fixture(scope="module")
def denoise_runs(tmp_path_factory):
    return run_world(denoise, 4, tmp_path_factory.mktemp("denoise"), (2, 2, 1), DENOISE_CASES,
                     _pipe_args(), DENOISE_SEED)


@pytest.mark.parametrize("case", DENOISE_CASES)
def test_sharded_denoise_matches_unsharded_port(denoise_runs, case):
    """A 2-step denoise of the tiny dev pipeline under dp2 x sp2 (4 ranks:
    each prepares its slab of the conditions and denoises) against the
    unsharded port with the same seeds.  Every rank passes the conditioning
    videos; only the leader passes the prompt embeddings and sampling
    arguments (steps, strength, guidance, dynamic CFG, generator); the other
    ranks run on what it hands on, Euler A's noise included.  Every rank's
    latents are bit-equal after every step."""
    from trajectorycrafter_tpu_torch.config import TrajCrafterConfig

    seed, args, runs = DENOISE_SEED, _pipe_args(), denoise_runs
    sampler, kwargs = DENOISE_CASES[case]
    cfg = TrajCrafterConfig()
    cfg.diffusion.sampler_name, cfg.diffusion.quant = sampler, "none"
    pipe = build_dev_models(cfg, "cpu", seed=seed).pipeline
    with torch.no_grad():
        want = pipe(*map(T, args), generator=torch.Generator().manual_seed(7),
                    output_type="latent", **kwargs).numpy()
    for run in runs:
        got = run[case]
        np.testing.assert_allclose(got["final"], want, atol=1e-4, rtol=1e-4)
        assert len(got["steps"]) == 2
        for step, first in zip(got["steps"], runs[0][case]["steps"]):
            np.testing.assert_array_equal(step, first)


# ----------------------------------------------------------------------------
# the entry points
# ----------------------------------------------------------------------------


def test_cli_reads_the_mesh_flags_and_refuses_a_mismatched_world(monkeypatch, tmp_path):
    argv = ["--video_path", CLIP, "--traj_txt", TRAJ, "--exp_name", "run",
            "--out_dir", str(tmp_path), "--mesh_dp", "2", "--mesh_sp", "2", "--mesh_tp", "2",
            "--dist_backend", "gloo"]
    args = cli.get_parser().parse_args(argv)
    cfg = cli.parse_config(argv)
    assert dataclasses.astuple(cfg.parallel)[:3] == (2, 2, 2)
    assert args.dist_backend == "gloo"

    def refuse(*a, **kw):
        raise AssertionError("a model was built")

    monkeypatch.setattr(orchestrator, "build_models", refuse)
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="= 8 ranks does not match the world of 1"):
        cli.main(argv)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="= 8 ranks does not match the world of 4"):
        cli.main(argv)
    with pytest.raises(ValueError, match="= 1 ranks does not match the world of 4"):
        cli.start_world(cli.parse_config(argv[:6]))
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(RuntimeError, match="no torchrun environment"):
        cli.start_world(cfg, "gloo")
    monkeypatch.delenv("WORLD_SIZE")
    assert cli.start_world(cli.parse_config(argv[:6])) is False  # 1x1x1: unsharded
    with pytest.raises(RuntimeError, match="need a process group"):
        orchestrator.stage_mesh(cfg)


@pytest.mark.parametrize("local_world, cards, want", [
    (4, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (4, 1, ["cuda:0"] * 4),
    (8, 4, ["cuda:0", "cuda:0", "cuda:1", "cuda:1", "cuda:2", "cuda:2", "cuda:3", "cuda:3"]),
    (2, 8, ["cuda:0", "cuda:1"]),
])
def test_torchrun_ranks_go_on_the_cards_and_nccl_refuses_shared_ones(monkeypatch, local_world,
                                                                     cards, want):
    """``init_from_env`` puts local rank r on its own card when the host has
    one a rank, else spreads the ranks evenly over the cards (gloo only:
    NCCL raises where ranks would share a card); a device the caller
    passes is used as it is."""
    started = []
    monkeypatch.setattr(D, "init", lambda backend, rank, world, method, device:
                        started.append((backend, rank, world, method, device)))
    monkeypatch.setattr(D.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("WORLD_SIZE", str(local_world))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    for r in range(local_world):
        monkeypatch.setenv("RANK", str(r))
        monkeypatch.setenv("LOCAL_RANK", str(r))
        D.init_from_env("gloo")
        if local_world <= cards:
            D.init_from_env("nccl")
        else:
            with pytest.raises(ValueError, match="duplicate GPU.*need --dist_backend gloo"):
                D.init_from_env("nccl")
        D.init_from_env("gloo", "cpu")
    shared = local_world > cards
    assert [s[4] for s in started if s[0] == "gloo" and s[4] != "cpu"] == want
    assert [s[4] for s in started if s[0] == "nccl"] == ([] if shared else want)
    assert [s[4] for s in started if s[4] == "cpu"] == ["cpu"] * local_world
    assert {s[1:4] for s in started} == {(r, local_world, "env://") for r in range(local_world)}


def test_a_backend_that_does_not_start_raises_without_fallback(tmp_path):
    """NCCL does not start on this CPU build: ``init`` raises and leaves no
    process group; nothing falls back to gloo.  NCCL refuses shared cards."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="nccl process group did not start.*no other"):
        D.init("nccl", 0, 1, f"file://{tmp_path / 'store'}", "cuda:0")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL runs on CUDA devices"):
        D.init("nccl", 0, 1, f"file://{tmp_path / 'store2'}", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        D.init("mpi", 0, 1, f"file://{tmp_path / 'store3'}", "cpu")


def test_a_pipeline_refuses_what_its_mesh_cannot_shard():
    """dp must divide the batch; the ring route needs its token shards; the
    heads must split over tp."""
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_unit_

    model = CrossTransformer3DModel(**DIMS)
    with pytest.raises(ValueError, match="do not split over tp=3"):
        shard_unit_(model.transformer_blocks[0], D.Axis("tp", 3, 0, (0, 1, 2)))
    model.transformer_blocks[0].attn1.attention_impl = "ring"
    args, rope = _inputs(), rope_for_sample(16, 64, 96, 3)
    with pytest.raises(ValueError, match="ring route and the ring needs token shards"):
        model(*map(T, args), image_rotary_emb=tuple(map(T, rope)))
