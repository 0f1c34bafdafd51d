"""The port's sharded LoRA training (training/step.py under a dp x tp mesh,
the tp autograd Functions of parallel/distributed.py, the sharded merge of
training/lora.py, ``scripts/train_lora.py --mesh_dp/--mesh_tp``) vs the
JAX package's ``make_train_step`` under ``make_mesh(dp=2, sp=1, tp=2)`` and
vs the port's unsharded step, on the CPU.

One real 4-rank gloo world (tests/torch_worlds.py; the ranks' side is
tests/torch_parallel_workers.py ``training_sharded``) runs every sharded
case; JAX runs on the virtual devices of tests/conftest.py.  The model is
tests/test_torch_training.py's tiny DiT (2 layers, 2 heads of 8, one
Perceiver; fp32), the same seeded weights and adapters on both sides, the
batches of 2 with ``timesteps`` and ``noise`` supplied and dropout 0 where
JAX is the reference (torch cannot replay a JAX key); the port's own draws
(dropout 0.1) where the unsharded port is.

Tolerances, as tests/test_torch_training.py states them (fp32 on both
sides; the sharded step sums the tp partials and the dp gradients in
another order): loss 1e-5 relative, gradients and grad norms 1e-4
relative L2, the adapters after two AdamW steps within 1e-5 absolutely
plus 1e-4 relatively.  The adapters are bit-equal on every rank after
every step.  Each planted fault must read at least 10x the sound reading
on the gradients it touches (the card's run T holds T2 to the same ratio).
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors.torch import save_file
from test_torch_training import (
    ALPHA,
    GRAD_REL_L2,
    LOSS_RTOL,
    RANK,
    STEP_ATOL,
    STEP_RTOL,
    TINY,
    _batch,
    _jax_lora,
    _lora_np,
    _port_lora,
    _port_model,
    _rel_l2,
)
from torch_parallel_workers import training_sharded
from torch_parity import fill_from_numpy_, jax_tree
from torch_worlds import run_world

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.parallel import dit_param_sharding, shard_batch
from trajectorycrafter_tpu.parallel import make_mesh as jax_make_mesh
from trajectorycrafter_tpu.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.training import TrainState as JaxTrainState
from trajectorycrafter_tpu.training import step as jstep
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel, FeedForward
from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
from trajectorycrafter_tpu_torch.scripts import train_lora
from trajectorycrafter_tpu_torch.training import step as tstep
from trajectorycrafter_tpu_torch.training.data import save_latent_sample

torch.set_num_threads(1)
FAULT_RATIO = 10.0
STEP = dict(rank=RANK, alpha=ALPHA, seed=0)
# name -> the step's settings; "jax": held to JAX's sharded step, else to
# the port's unsharded step with the port's own draws
CASES = {
    "plain": dict(STEP, accum=1, motion=False, dropout=0.0, jax=True),
    "motion, accumulation 2": dict(STEP, accum=2, motion=True, dropout=0.0, jax=True),
    "draws, dropout 0.1": dict(STEP, accum=1, motion=False, dropout=0.1, jax=False),
}


def _batches(case):
    rng = np.random.default_rng(21)
    out = [_batch(rng, 2) for _ in range(2)]
    if not case["jax"]:
        for b in out:
            del b["timesteps"], b["noise"]
    return out


def _write_samples(root, n=4):
    rng = np.random.default_rng(14)
    root.mkdir()
    for i in range(n):
        save_latent_sample(str(root / f"sample_{i:06d}.npz"),
                           gt_latents=rng.standard_normal((2, 4, 4, 4)).astype(np.float32),
                           ref_latents=rng.standard_normal((1, 4, 4, 4)).astype(np.float32),
                           inpaint_latents=rng.standard_normal((2, 4, 4, 5)).astype(np.float32),
                           prompt_embeds=rng.standard_normal((3, 8)).astype(np.float32))
    return root


def _script_argv(data, out):
    return ["--data_dir", str(data), "--output_dir", str(out), "--train_steps", "2",
            "--batch_size", "2", "--checkpointing_steps", "1", "--log_every", "1",
            "--learning_rate", "1e-3", "--seed", "0", "--validate_every", "1",
            "--val_fraction", "0.25"]


def _tree(tmp_path):
    """A tiny DiT checkpoint (safetensors + config.json) for ``load_dit``."""
    import json

    model = fill_from_numpy_(CrossTransformer3DModel(**TINY), 3)
    path = tmp_path / "transformer"
    path.mkdir()
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    save_file(sd, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(TINY))
    return str(path), {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def setup():
    params = jax_tree(CrossTransformer3DModel(**TINY), 0, convert_dit,
                      num_layers=TINY["num_layers"])
    sched = JaxDDIM()
    return dict(params=params, jmodel=JaxDiT(**TINY, attention_impl="xla"), jsched=sched,
                jstate=sched.set_timesteps(50), lora=_lora_np(params))


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(4)
    ff = fill_from_numpy_(FeedForward(32), 6)
    ff_case = ({k: v.numpy() for k, v in ff.state_dict().items()},
               rng.standard_normal((2, 5, 32)).astype(np.float32),
               rng.standard_normal((2, 5, 32)).astype(np.float32))
    step_cases = {name: (setup["params"], TINY, setup["lora"], case, _batches(case))
                  for name, case in CASES.items()}
    grad_case = (setup["params"], TINY, setup["lora"], CASES["plain"],
                 _batches(CASES["plain"])[0])
    data = _write_samples(tmp / "data")
    argv = _script_argv(data, tmp / "sharded") + ["--mesh_dp", "2", "--mesh_tp", "2",
                                                  "--dist_backend", "gloo"]
    resume = argv + ["--train_steps", "3", "--resume_from_checkpoint", "latest"]
    runs = run_world(training_sharded, 4, tmp, ff_case, step_cases, grad_case,
                     (argv, resume), _tree(tmp))
    return runs, ff_case, data, tmp


# ----------------------------------------------------------------------------
# the tp autograd Functions
# ----------------------------------------------------------------------------


def test_tp_functions_give_the_unsharded_layers_gradients(world):
    """A feed-forward with its first layer column- and second row-parallel
    over tp 2: the input's gradient (the column input summed over tp in the
    backward pass) and each rank's rows / columns of the weights' gradients
    are the unsharded layer's; without the column input's reduction the
    input's gradient reads at least 10x the sound reading."""
    runs, (weights, x, dout), _, _ = world
    ff = FeedForward(32)
    ff.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    xi = torch.from_numpy(x).requires_grad_()
    y = ff(xi)
    gx, g1, g2 = torch.autograd.grad(y, [xi, ff.net[0].proj.weight, ff.net[2].weight],
                                     torch.from_numpy(dout))
    for r, run in enumerate(runs[:2]):
        sound = run["ff"]["sound"]
        np.testing.assert_allclose(sound["y"], y.detach().numpy(), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(sound["x"], gx.numpy(), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(sound["w1"], np.split(g1.numpy(), 2, 0)[r], atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(sound["w2"], np.split(g2.numpy(), 2, 1)[r], atol=1e-6,
                                   rtol=1e-5)
        wrong = run["ff"]["column input unreduced"]["x"]
        assert _rel_l2(wrong, gx.numpy()) >= FAULT_RATIO * max(_rel_l2(sound["x"], gx.numpy()),
                                                               1e-7)
    assert all("ff" not in run for run in runs[2:])  # the tp 2 mesh idles ranks 2-3


# ----------------------------------------------------------------------------
# the sharded step
# ----------------------------------------------------------------------------


def _jax_sharded_steps(setup, case, batches):
    mesh = jax_make_mesh(dp=2, sp=1, tp=2, devices=jax.devices()[:4])
    params = jax.device_put(setup["params"], dit_param_sharding(setup["params"], mesh))
    opt = jstep.make_optimizer(lr=1e-3, grad_accum_steps=case["accum"])
    lora = _jax_lora(setup["lora"])
    state = JaxTrainState(lora=lora, opt_state=opt.init(lora), step=jnp.zeros((), jnp.int32))
    fn = jstep.make_train_step(setup["jmodel"], params, setup["jsched"], setup["jstate"], opt,
                               cfg_dropout_prob=0.0, motion_sub_loss=case["motion"],
                               lora_alpha=ALPHA, lora_rank=RANK)
    metrics = []
    with jax.set_mesh(mesh):
        jfn = jax.jit(fn)
        for b in batches:
            batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                   shard_batch(b, mesh))
            state, m = jfn(state, batch, jax.random.PRNGKey(0))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree.map(np.asarray, state.lora), metrics


def _port_unsharded(setup, case, batches):
    """The unsharded port's steps on the same batches and draws; and the
    global norm of the mean of the micro-gradients at each update."""
    model = _port_model(setup["params"], attention_impl="flash_stock", remat=True)
    sched = CogVideoXDDIMScheduler()
    opt = tstep.make_optimizer(lr=1e-3, grad_accum_steps=case["accum"])
    fn = tstep.make_train_step(model, sched, sched.set_timesteps(50), opt,
                               cfg_dropout_prob=case["dropout"], motion_sub_loss=case["motion"],
                               lora_alpha=ALPHA, lora_rank=RANK)
    lora = _port_lora(setup["lora"])
    state = tstep.TrainState(lora, opt.init(lora), 0)
    gen = torch.Generator().manual_seed(case["seed"])
    norms, update = [], opt.update
    opt.update = lambda grads, st, reduce=None: norms.append(update(grads, st))
    metrics = []
    for b in batches:
        state, m = fn(state, b, gen)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state.lora, metrics, [None if n is None else n.item() for n in norms]


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_jax_and_the_unsharded_port(setup, world, name):
    """Two steps under dp 2 x tp 2: the loss (the mean over dp) and grad
    norm of each step and the adapters after them against JAX's sharded
    step (fed the same timesteps and noise) or the port's unsharded step
    (the same generator: every rank draws the global batch's timesteps,
    noise and masks and takes its rows); with accumulation the grad norm is
    the reduced running mean's at the update and NaN before it.  Every rank
    holds the same adapters, bit for bit, after every step."""
    case, runs = CASES[name], world[0]
    batches = _batches(case)
    port_lora, port_metrics, norms = _port_unsharded(setup, case, batches)
    want_norms = [n if n is not None else np.nan for n in norms]
    got = runs[0]["steps"][name]
    for run in runs[1:]:
        assert run["steps"][name]["sums"] == got["sums"]
        for k, v in run["steps"][name]["lora"].items():
            np.testing.assert_array_equal(v, got["lora"][k])
    losses, gnorms = np.asarray(got["metrics"]).T
    np.testing.assert_allclose(gnorms, want_norms, rtol=GRAD_REL_L2)
    if case["jax"]:
        want_lora, want_metrics = _jax_sharded_steps(setup, case, batches)
        np.testing.assert_allclose(losses, np.asarray(want_metrics)[:, 0], rtol=LOSS_RTOL)
        if case["accum"] == 1:
            np.testing.assert_allclose(gnorms, np.asarray(want_metrics)[:, 1], rtol=GRAD_REL_L2)
    else:
        np.testing.assert_allclose(losses, np.asarray(port_metrics)[:, 0], rtol=LOSS_RTOL)
        from trajectorycrafter_tpu_torch.utils.weights import lora_to_jax

        want_lora = lora_to_jax(port_lora)
    from trajectorycrafter_tpu_torch.utils.weights import lora_to_jax

    flat = lora_to_jax({k: torch.from_numpy(v) for k, v in got["lora"].items()})
    for key in want_lora:
        for part in ("a", "b"):
            np.testing.assert_allclose(flat[key][part], want_lora[key][part], atol=STEP_ATOL,
                                       rtol=STEP_RTOL, err_msg=f"{key} {part}")
    np.testing.assert_allclose(
        np.concatenate([v.detach().numpy().ravel() for v in port_lora.values()]),
        np.concatenate([got["lora"][k].ravel() for k in port_lora]), atol=STEP_ATOL,
        rtol=STEP_RTOL)


def test_reduced_gradients_and_planted_faults(setup, world):
    """One batch's adapter gradients reduced over dp 2 x tp 2 against the
    unsharded port's: the replicated top-level ``proj_out``'s adapter is not
    summed over tp (every tp rank holds its whole gradient), and the dp
    gradients are averaged.  The planted faults -- ``proj_out`` summed over
    tp, the dp gradients summed -- read at least 10x the sound reading on
    the adapters they touch."""
    runs = world[0]
    batch = _batches(CASES["plain"])[0]
    model = _port_model(setup["params"], attention_impl="flash_stock", remat=True)
    sched = CogVideoXDDIMScheduler()
    fn = tstep.make_loss_fn(model, sched, sched.set_timesteps(50), cfg_dropout_prob=0.0,
                            lora_alpha=ALPHA, lora_rank=RANK)
    lora = _port_lora(setup["lora"])
    grads = torch.autograd.grad(fn(lora, batch, 0), list(lora.values()))
    want = {k: g.numpy() for k, g in zip(lora, grads)}
    reading = lambda got, keys: _rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                                        np.concatenate([want[k].ravel() for k in keys]))
    proj_out = [k for k in want if k.startswith("proj_out.")]
    assert len(proj_out) == 2
    for run in runs:
        sound = run["grads"][None]
        assert set(sound) == set(want)
        for k in want:
            assert _rel_l2(sound[k], want[k]) <= GRAD_REL_L2, k
        for fault, keys in (("proj_out summed over tp", proj_out), ("dp summed", list(want))):
            assert reading(run["grads"][fault], keys) >= FAULT_RATIO * max(
                reading(sound, keys), 1e-7), fault
        np.testing.assert_allclose(run["grads"]["proj_out summed over tp"][proj_out[0]],
                                   2 * want[proj_out[0]], rtol=1e-4, atol=1e-9)


def test_load_dit_cuts_each_tensor_to_the_rank_s_shard(world):
    assert all(run["load_dit"] for run in world[0])


# ----------------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------------


def test_train_script_under_the_mesh_matches_one_process(world, tmp_path, monkeypatch):
    """``scripts/train_lora.main`` with ``--mesh_dp 2 --mesh_tp 2`` in the
    4-rank world: rank 0 alone writes the checkpoints, ``metrics.jsonl``
    and ``lora_final``; every rank resumes from ``latest``; the adapters,
    losses and validation losses are the single-process run's."""
    import json

    runs, _, data, tmp = world
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the jsonl alone
    single = train_lora.main(_script_argv(data, tmp_path / "single"), device="cpu")
    for r, run in enumerate(runs):
        script = run["script"]
        assert script["train"]["step"] == 2 and script["resume"]["step"] == 3
        assert script["train"]["writes"] == ([1, 2, 2] if r == 0 else [])
        assert script["resume"]["writes"] == ([3, 3] if r == 0 else [])
        for k, v in single.lora.items():
            np.testing.assert_allclose(script["train"]["lora"][k], v.detach().numpy(),
                                       atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=k)
            np.testing.assert_array_equal(script["train"]["lora"][k],
                                          runs[0]["script"]["train"]["lora"][k])
    read = lambda path: [json.loads(line) for line in open(path)]
    sharded, one = read(tmp / "sharded" / "metrics.jsonl"), read(tmp_path / "single" /
                                                                  "metrics.jsonl")
    assert [r["step"] for r in sharded] == [1, 1, 2, 2, 3, 3]  # loss and val_loss, once each
    for a, b in zip(sharded, one):
        for key in ("loss", "val_loss"):
            if key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL)


def test_mesh_flags_need_a_world_and_a_batch_that_dp_divides(tmp_path, monkeypatch):
    data = _write_samples(tmp_path / "data")
    argv = _script_argv(data, tmp_path / "out")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="= 4 ranks does not match the world of 1"):
        train_lora.main(argv + ["--mesh_dp", "2", "--mesh_tp", "2"], device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="--batch_size 3 is not a multiple of --mesh_dp 4"):
        train_lora.main(argv + ["--mesh_dp", "4", "--batch_size", "3"], device="cpu")


def test_a_shard_holds_only_its_part():
    """Every tensor of a tp shard has storage of its own size: a column-
    parallel layer's rows are a view of the whole weight, which would keep
    the whole weight alive beside the shard."""
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_units_

    model = CrossTransformer3DModel(**TINY)
    whole = sum(p.numel() for p in model.parameters())
    shard_units_(model, D.Axis("tp", 2, 1, (0, 1)))
    params = list(model.parameters())
    assert all(p.untyped_storage().nbytes() == p.numel() * p.element_size() for p in params)
    assert sum(p.numel() for p in params) < whole
