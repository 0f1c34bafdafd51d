"""The port's GPipe block stack (trajectorycrafter_tpu_torch/parallel/
pipeline.py) and the mesh's pp axis vs the JAX package's
parallel/pipeline.py and parallel/mesh.py, on the CPU.

The stages run in a real 4-rank gloo world (tests/torch_worlds.py; the
ranks' side is tests/torch_parallel_workers.py ``pipeline_stages``): pp 2
on ranks 0-1 (the mesh leaves ranks 2-3 idle, as JAX's warns) and pp 2 x
tp 2 on all four.  JAX runs ``pipeline_dit_blocks`` on a 2-device virtual
mesh and on a (pp, tp) mesh of 4 (tests/conftest.py forces 8 host
devices).  Both sides get the same weights (numpy from a seed through the
weight bridge) and inputs: the tiny DiT of 2 heads x 16, 4 layers (2
superblocks), 2 Perceivers of 2 heads x 8, fp32.

Tolerances: the unquantized stack 2e-5 absolute and relative, JAX's own
limit for its pipeline against its sequential loop (fp32 sums in another
order); int8 2^-6 of the output's largest magnitude, as
tests/test_torch_parallel.py holds the int8 DiT (a reordered fp32 sum can
move an activation across a code's rounding boundary).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh as JaxMesh
from torch_parallel_workers import pipeline_stages
from torch_parity import jax_tree
from torch_worlds import run_world

import torch
from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.ops import int8 as jax_int8
from trajectorycrafter_tpu.parallel import make_mesh as jax_make_mesh
from trajectorycrafter_tpu.parallel import pipeline as jpipe
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel import pipeline as tpipe
from trajectorycrafter_tpu_torch.parallel.mesh import mesh_ranks

torch.set_num_threads(1)
DIMS = dict(num_attention_heads=2, attention_head_dim=16, in_channels=9, out_channels=4,
            time_embed_dim=32, text_embed_dim=32, num_layers=4, max_text_seq_length=3,
            cross_attn_dim_head=8, cross_attn_num_heads=2)
PP, PP_TP = (1, 1, 1, 2), (1, 1, 2, 2)
EXACT_TOL = dict(atol=2e-5, rtol=2e-5)
INT8_TOL = 2.0 ** -6
# name -> (mesh, int8, remat, rope, microbatches)
CASES = {
    "pp2": (PP, False, False, True, 2),
    "pp2 M1 no rope": (PP, False, False, False, 1),
    "pp2 int8 remat": (PP, True, True, True, 2),
    "pp2 x tp2": (PP_TP, False, False, True, 2),
}


@pytest.fixture(scope="module")
def params():
    p = jax_tree(CrossTransformer3DModel(**DIMS), 0, convert_dit, num_layers=4)
    return {False: p, True: jax.tree.map(np.asarray, jax_int8.quantize_dit_params(p))}


def _inputs():
    rng = np.random.default_rng(3)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)
    rope = tuple(np.asarray(t, np.float32) for t in rope_for_sample(16, 64, 96, 2))  # 48 tokens
    return normal(2, 48, 32), normal(2, 3, 32), normal(2, 32), normal(2, 24, 32), rope


def _jax_pipeline(params, quant, remat, use_rope, m, tp):
    hidden, encoder, temb, cross, rope = map(
        lambda x: tuple(map(jnp.asarray, x)) if isinstance(x, tuple) else jnp.asarray(x),
        _inputs())
    model = JaxDiT(**DIMS, attention_impl="xla", quant="int8" if quant else "none", remat=remat)
    stacked = jpipe.stack_superblock_params(params, 4, 2, 2)
    devices = np.array(jax.devices()[:2 * tp])
    if tp == 1:
        mesh = JaxMesh(devices, ("pp",))
    else:
        mesh = JaxMesh(devices.reshape(2, tp), ("pp", "tp"))
        stacked = jax.device_put(stacked, jpipe.stacked_param_sharding(stacked, mesh))
    h, e = jpipe.pipeline_dit_blocks(model, stacked, hidden, encoder, temb,
                                     rope if use_rope else None, cross, mesh, n_microbatches=m)
    return np.asarray(h), np.asarray(e)


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    cases = {name: (shape, params[quant], quant, remat, use_rope, m)
             for name, (shape, quant, remat, use_rope, m) in CASES.items()}
    return run_world(pipeline_stages, 4, tmp_path_factory.mktemp("pipe"), [PP, PP_TP], cases,
                     DIMS, _inputs())


@pytest.mark.parametrize("name", CASES)
def test_gpipe_matches_jax(runs, params, name):
    """Every rank of the pp axis (and of each tp coordinate) returns the
    stack's (hidden, encoder), equal to JAX's ``pipeline_dit_blocks`` on the
    same weights; a stage keeps only its superblocks' blocks; the last
    stage's hop sends nothing."""
    shape, quant, remat, use_rope, m = CASES[name]
    want = _jax_pipeline(params[quant], quant, remat, use_rope, m, shape[2])
    outs = [run[name] for run in runs if name in run]
    assert len(outs) == int(np.prod(shape))
    for o in outs:
        for got, ref in zip((o["hidden"], o["encoder"]), want):
            if quant:
                assert np.abs(got - ref).max() <= INT8_TOL * np.abs(ref).max()
            else:
                np.testing.assert_allclose(got, ref, **EXACT_TOL)
        tp, pp = o["coords"]
        assert o["held"] == [2 * pp, 2 * pp + 1]
        # stage 0 sends each microbatch's (hidden, encoder) once
        hop = 2 * (48 + 3) * 32 * 4 if pp == 0 else 0
        assert o["hop_bytes"] == hop


def test_gpipe_output_is_the_sequential_loop(runs, params):
    """The pp 2 stack against the port's own sequential loop
    (``run_blocks`` of the whole model) on the same inputs."""
    from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax

    hidden, encoder, temb, cross, rope = _inputs()
    model = CrossTransformer3DModel(**DIMS)
    model.load_state_dict(dit_from_jax(params[False]), strict=True)
    T = torch.from_numpy
    with torch.no_grad():
        h, e = model.eval().run_blocks(T(hidden), T(encoder), T(temb), tuple(map(T, rope)),
                                       T(cross))
    for run in runs[:2]:  # the pp 2 mesh leaves ranks 2-3 idle
        np.testing.assert_allclose(run["pp2"]["hidden"], h.numpy(), **EXACT_TOL)
        np.testing.assert_allclose(run["pp2"]["encoder"], e.numpy(), **EXACT_TOL)


def _jax_stage_blocks(n_stages):
    """Which blocks and Perceivers JAX's ``stack_superblock_params`` puts in
    each stage, read off a tree whose leaves are the block indices."""
    tree = {f"blocks_{i}": {"w": np.array([i])} for i in range(42)}
    tree.update({f"perceiver_cross_attention_{i}": {"w": np.array([100 + i])}
                 for i in range(21)})
    stacked = jpipe.stack_superblock_params(tree, 42, 2, n_stages)
    return [sorted(np.asarray(stacked[k]["w"])[s].reshape(-1).tolist()
                   for k in ("a", "b", "p")) for s in range(n_stages)]


@pytest.mark.parametrize("n_stages", [3, 7, 21])
def test_superblock_ownership_matches_jax(n_stages):
    """At the deployed 42 blocks, each stage's blocks and Perceivers as
    JAX stacks them; a rank's other blocks and Perceivers go to meta."""
    with torch.device("meta"):
        model = CrossTransformer3DModel(num_layers=42)
    stages = tpipe.stack_superblock_params(model, n_stages)
    want = _jax_stage_blocks(n_stages)
    for s, su in enumerate(stages):
        blocks = [b for i in su for b in (2 * i, 2 * i + 1)]
        assert [sorted(blocks[0::2]), sorted(blocks[1::2]), [100 + i for i in su]] == want[s]

    tiny = CrossTransformer3DModel(**{**DIMS, "num_layers": 6})
    stages = tpipe.stack_superblock_params(tiny, 3, stage=1)
    assert stages == [range(0, 1), range(1, 2), range(2, 3)]
    on_device = lambda units: [not next(u.parameters()).is_meta for u in units]
    assert on_device(tiny.transformer_blocks) == [False, False, True, True, False, False]
    assert on_device(tiny.perceiver_cross_attention) == [False, True, False]


def test_stage_count_must_divide_the_superblocks_as_jax_asserts():
    with torch.device("meta"):
        model = CrossTransformer3DModel(num_layers=42)
    with pytest.raises(AssertionError):
        _jax_stage_blocks(2)
    with pytest.raises(ValueError, match="2 stages do not divide the 21 superblocks"):
        tpipe.stack_superblock_params(model, 2)


@pytest.mark.parametrize("shape", [(1, 1, 2, 2), (2, 1, 1, 2), (1, 2, 1, 2), (1, 1, 1, 4)],
                         ids=str)
def test_mesh_ranks_with_pp_as_jax(shape):
    """pp is the fastest axis of JAX's (dp, sp, tp, pp) order."""
    want = np.vectorize(lambda d: d.id)(jax_make_mesh(*shape).devices)
    got = mesh_ranks(*shape, world_size=8)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


def test_microbatches_must_divide_the_batch():
    from types import SimpleNamespace

    hidden, encoder, temb, cross, rope = (torch.zeros(3, 4, 32), torch.zeros(3, 2, 32),
                                          torch.zeros(3, 32), torch.zeros(3, 4, 32), None)
    mesh = SimpleNamespace(pp=D.Axis("pp", 2, 0, (0, 1)), sp=D.Axis("sp", 1, 0, (0,)))
    with pytest.raises(ValueError, match="a batch of 3 does not split into 2 microbatches"):
        tpipe.pipeline_dit_blocks(None, [range(0, 1), range(1, 2)], hidden, encoder, temb, rope,
                                  cross, mesh, n_microbatches=2)
