"""Port LoRA training (trajectorycrafter_tpu_torch/training/,
scripts/train_lora.py) vs the JAX package's training/.

A tiny DiT (2 layers, 2 heads of 8, one Perceiver; fp32) gets the same
seeded weights on both sides (``jax_tree`` -> ``dit_from_jax``), the same
adapters (numpy, JAX layout -> ``lora_from_jax``; B nonzero so that dA is
too) and the same batches with ``timesteps`` and ``noise`` supplied (torch
cannot replay a JAX key) at dropout 0.  The JAX model runs
``attention_impl="xla"``; the port runs ``flash_stock`` with ``remat``,
the training build, whose autograd Function and recomputation take their
plain versions on the CPU.

Tolerances (both sides fp32; they differ in summation order and in torch's
AdamW arithmetic against optax's):
  * loss: 1e-5 relative;
  * gradients: per adapter, the relative L2 error against JAX's <= 1e-4;
  * three AdamW steps and the accumulated micro-steps: the adapters within
    1e-5 of JAX's absolutely plus 1e-4 relatively (AdamW moves every value by
    about lr = 1e-3 a step, whatever its gradient's size);
  * remat on and off: equal gradients to 1e-6.
Dropout cannot be replayed from a JAX key either; it is held to its
properties on a model that records what it is given.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.training import TrainState as JaxTrainState
from trajectorycrafter_tpu.training import lora as jlora
from trajectorycrafter_tpu.training import step as jstep
from trajectorycrafter_tpu.training import validation as jval
from trajectorycrafter_tpu.training.data import LatentsDataset as JaxLatentsDataset
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
from trajectorycrafter_tpu_torch.training import lora as tlora
from trajectorycrafter_tpu_torch.training import step as tstep
from trajectorycrafter_tpu_torch.training import validation as tval
from trajectorycrafter_tpu_torch.training.data import LatentsDataset, save_latent_sample
from trajectorycrafter_tpu_torch.utils.weights import (
    dit_dense_path,
    dit_from_jax,
    lora_from_jax,
    lora_to_jax,
)

torch.set_num_threads(1)
F, H, W, C = 2, 4, 4, 4
TEXT = (3, 8)
RANK, ALPHA = 2, 4.0
TINY = dict(num_attention_heads=2, attention_head_dim=8, in_channels=2 * C + 1,
            out_channels=C, time_embed_dim=16, text_embed_dim=TEXT[1], num_layers=2,
            max_text_seq_length=TEXT[0], cross_attn_dim_head=8, cross_attn_num_heads=2,
            use_rotary_positional_embeddings=True)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
STEP_ATOL, STEP_RTOL = 1e-5, 1e-4


def _port_model(params, **kw):
    model = CrossTransformer3DModel(**TINY, **kw)
    model.load_state_dict(dit_from_jax(params), strict=True)
    return model.eval()


def _lora_np(params, seed=1):
    """Adapters in JAX's layout for every target, B nonzero."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in jlora.lora_target_paths(params):
        names = [getattr(p, "key", str(p)) for p in path]
        kernel = params
        for n in names:
            kernel = kernel[n]
        d_in, d_out = kernel.shape
        out["/".join(names)] = {
            "a": (rng.standard_normal((d_in, RANK)) / RANK).astype(np.float32),
            "b": (0.1 * rng.standard_normal((RANK, d_out))).astype(np.float32)}
    return out


def _port_lora(flat):
    return {k: v.requires_grad_() for k, v in lora_from_jax(flat).items()}


def _batch(rng, n):
    return {
        "gt_latents": rng.standard_normal((n, F, H, W, C)).astype(np.float32),
        "prompt_embeds": rng.standard_normal((n, *TEXT)).astype(np.float32),
        "ref_latents": rng.standard_normal((n, 1, H, W, C)).astype(np.float32),
        "inpaint_latents": rng.standard_normal((n, F, H, W, C + 1)).astype(np.float32),
        "timesteps": rng.integers(0, 1000, (n,)).astype(np.int32),
        "noise": rng.standard_normal((n, F, H, W, C)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def setup():
    params = jax_tree(CrossTransformer3DModel(**TINY), 0, convert_dit,
                      num_layers=TINY["num_layers"])
    jmodel = JaxDiT(**TINY, attention_impl="xla")
    sched, tsched = JaxDDIM(), CogVideoXDDIMScheduler()
    return dict(params=params, jmodel=jmodel, jsched=sched, jstate=sched.set_timesteps(50),
                tsched=tsched, tstate=tsched.set_timesteps(50), lora=_lora_np(params))


def _jax_lora(flat):
    return jax.tree.map(jnp.asarray, flat)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ----------------------------------------------------------------------------
# adapters
# ----------------------------------------------------------------------------


def _jax_names(paths):
    return sorted("/".join(getattr(p, "key", str(p)) for p in path) for path in paths)


def test_lora_targets_match_jax(setup):
    model = _port_model(setup["params"])
    port = tlora.lora_target_paths(model)
    assert sorted(dit_dense_path(n) + "/kernel" for n in port) == _jax_names(
        jlora.lora_target_paths(setup["params"]))
    assert len(port) == 2 * 6 + 1 * 3 + 1
    skip = tlora.lora_target_paths(model, skip_substrings=("perceiver",))
    assert sorted(dit_dense_path(n) + "/kernel" for n in skip) == _jax_names(
        jlora.lora_target_paths(setup["params"], skip_substrings=("perceiver",)))


def test_lora_targets_at_full_width_match_jax():
    """Shapes only: the full-width JAX tree by ``jax.eval_shape``, the port's
    model on the meta device; 316 layers (5.29 B of the 6.10 B parameters)."""
    jmodel = JaxDiT(dtype=jnp.bfloat16)
    z = lambda *s: jnp.zeros(s)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), z(1, 1, 4, 4, 16),
                            z(1, 226, 4096), z(1), z(1, 1, 4, 4, 17), z(1, 1, 4, 4, 16))
    want = _jax_names(jlora.lora_target_paths(shapes["params"]))
    with torch.device("meta"):
        model = CrossTransformer3DModel()
    port = tlora.lora_target_paths(model)
    assert len(port) == 316
    assert sorted(dit_dense_path(n) + "/kernel" for n in port) == want
    adapted = sum(model.get_submodule(n).weight.numel() for n in port)
    total = sum(p.numel() for p in model.parameters())
    assert 5.28e9 < adapted < 5.30e9 and 6.09e9 < total < 6.11e9


def test_lora_round_trip(setup):
    flat = setup["lora"]
    back = lora_to_jax(lora_from_jax(flat))
    assert back.keys() == flat.keys()
    for key in flat:
        for part in ("a", "b"):
            np.testing.assert_array_equal(back[key][part], flat[key][part])


def test_init_draws_a_over_rank_and_zero_b(setup):
    model = _port_model(setup["params"])
    gen = torch.Generator().manual_seed(0)
    lora = tlora.init_lora_params(gen, model, rank=8)
    assert len(lora) == 2 * len(tlora.lora_target_paths(model))
    a = torch.cat([v.flatten() for k, v in lora.items() if k.endswith("lora_A")])
    assert all(not v.any() for k, v in lora.items() if k.endswith("lora_B"))
    assert abs(a.std().item() * 8 - 1.0) < 0.1 and a.dtype == torch.float32
    flat = lora_to_jax(lora)
    for key, ab in flat.items():  # JAX's layout: a (in, r), b (r, out)
        kernel = setup["params"]
        for n in key.split("/"):
            kernel = kernel[n]
        assert ab["a"].shape == (kernel.shape[0], 8) and ab["b"].shape == (8, kernel.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_lora_merges_as_jax(setup, dtype):
    """W + (alpha / r) (a b) cast to W's dtype: the merged weights equal JAX's
    apply_lora (bf16: the same rounding of the sum)."""
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    params = jax.tree.map(lambda x: jnp.asarray(x, jdtype), setup["params"])
    merged = jlora.apply_lora(params, _jax_lora(setup["lora"]), ALPHA, RANK)
    model = _port_model(setup["params"]).to(dtype)
    tlora.apply_lora(model, _port_lora(setup["lora"]), ALPHA, RANK)
    for key in setup["lora"]:
        leaf = merged
        for n in key.split("/"):
            leaf = leaf[n]
        want = np.asarray(leaf.astype(jnp.float32)).T
        got = model.get_submodule(tlora_module(key)).weight.detach().float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == torch.float32 else 2 ** -7,
                                   atol=1e-7)
    tlora.remove_lora(model)
    np.testing.assert_array_equal(model.proj_out.weight.detach().float().numpy(),
                                  np.asarray(params["proj_out"]["kernel"].astype(jnp.float32)).T)


def tlora_module(jax_key):
    from trajectorycrafter_tpu_torch.utils.weights import dit_dense_module

    return dit_dense_module(jax_key)


# ----------------------------------------------------------------------------
# the loss, its gradients, the steps
# ----------------------------------------------------------------------------

CASES = [("v_prediction", False), ("v_prediction", True), ("epsilon", False),
         ("epsilon", True)]


@pytest.fixture(scope="module")
def jax_losses(setup):
    """JAX's loss and adapter gradients for each CASE on one batch."""
    batch = _batch(np.random.default_rng(5), 2)
    out = {}
    for pred, motion in CASES:
        fn = jstep.make_loss_fn(setup["jmodel"], setup["params"], setup["jsched"],
                                setup["jstate"], prediction_type=pred, cfg_dropout_prob=0.0,
                                motion_sub_loss=motion, lora_alpha=ALPHA, lora_rank=RANK)
        loss, grads = jax.jit(jax.value_and_grad(fn))(
            _jax_lora(setup["lora"]), {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
        out[(pred, motion)] = (float(loss), jax.tree.map(np.asarray, grads))
    return batch, out


@pytest.mark.parametrize("pred,motion", CASES)
def test_loss_and_gradients_match_jax(setup, jax_losses, pred, motion):
    batch, want = jax_losses
    want_loss, want_grads = want[(pred, motion)]
    model = _port_model(setup["params"], attention_impl="flash_stock", remat=True)
    fn = tstep.make_loss_fn(model, setup["tsched"], setup["tstate"], prediction_type=pred,
                            cfg_dropout_prob=0.0, motion_sub_loss=motion, lora_alpha=ALPHA,
                            lora_rank=RANK)
    lora = _port_lora(setup["lora"])
    loss = fn(lora, batch, 0)
    grads = dict(zip(lora, torch.autograd.grad(loss, list(lora.values()))))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    got = lora_to_jax(grads)
    assert got.keys() == want_grads.keys()
    for key in got:
        for part in ("a", "b"):
            assert _rel_l2(got[key][part], want_grads[key][part]) <= GRAD_REL_L2, (key, part)


def test_remat_gives_the_same_gradients(setup):
    batch = _batch(np.random.default_rng(6), 2)
    grads = []
    for remat in (False, True):
        model = _port_model(setup["params"], attention_impl="flash_stock", remat=remat)
        fn = tstep.make_loss_fn(model, setup["tsched"], setup["tstate"], cfg_dropout_prob=0.0,
                                lora_alpha=ALPHA, lora_rank=RANK)
        lora = _port_lora(setup["lora"])
        grads.append(torch.autograd.grad(fn(lora, batch, 0), list(lora.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def _jax_steps(setup, batches, opt, rng_seed=0):
    fn = jax.jit(jstep.make_train_step(setup["jmodel"], setup["params"], setup["jsched"],
                                       setup["jstate"], opt, cfg_dropout_prob=0.0,
                                       lora_alpha=ALPHA, lora_rank=RANK))
    lora = _jax_lora(setup["lora"])
    state = JaxTrainState(lora=lora, opt_state=opt.init(lora), step=jnp.zeros((), jnp.int32))
    metrics = []
    for b in batches:
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()},
                      jax.random.PRNGKey(rng_seed))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree.map(np.asarray, state.lora), metrics


def _port_steps(setup, batches, opt):
    model = _port_model(setup["params"], attention_impl="flash_stock", remat=True)
    fn = tstep.make_train_step(model, setup["tsched"], setup["tstate"], opt,
                               cfg_dropout_prob=0.0, lora_alpha=ALPHA, lora_rank=RANK)
    lora = _port_lora(setup["lora"])
    state = tstep.TrainState(lora, opt.init(lora), 0)
    metrics = []
    for b in batches:
        state, m = fn(state, b, 0)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state, metrics


def _assert_adapters_close(port_lora, jax_lora):
    got = lora_to_jax(port_lora)
    for key in jax_lora:
        for part in ("a", "b"):
            np.testing.assert_allclose(got[key][part], jax_lora[key][part], atol=STEP_ATOL,
                                       rtol=STEP_RTOL, err_msg=f"{key} {part}")


def test_three_adamw_steps_match_optax(setup):
    """lr 1e-3, clip at 1.0 (the gradients' norm is above it: the clip acts)."""
    rng = np.random.default_rng(7)
    batches = [_batch(rng, 1) for _ in range(3)]
    want_lora, want = _jax_steps(setup, batches, jstep.make_optimizer(lr=1e-3))
    state, got = _port_steps(setup, batches, tstep.make_optimizer(lr=1e-3))
    assert state.step == 3
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4)
    assert got[0][1] > 1.0
    _assert_adapters_close(state.lora, want_lora)


def test_accumulated_micro_steps_match_one_batch_and_multisteps(setup):
    rng = np.random.default_rng(8)
    big = _batch(rng, 4)
    micro = [{k: v[i:i + 1] for k, v in big.items()} for i in range(4)]
    want_lora, _ = _jax_steps(setup, micro, jstep.make_optimizer(lr=1e-3, grad_accum_steps=4))
    one, _ = _port_steps(setup, [big], tstep.make_optimizer(lr=1e-3))
    opt = tstep.make_optimizer(lr=1e-3, grad_accum_steps=4)
    model = _port_model(setup["params"], attention_impl="flash_stock", remat=True)
    fn = tstep.make_train_step(model, setup["tsched"], setup["tstate"], opt,
                               cfg_dropout_prob=0.0, lora_alpha=ALPHA, lora_rank=RANK)
    lora = _port_lora(setup["lora"])
    state = tstep.TrainState(lora, opt.init(lora), 0)
    start = {k: v.detach().clone() for k, v in lora.items()}
    for i, b in enumerate(micro):
        state, _ = fn(state, b, 0)
        changed = any(not torch.equal(start[k], v) for k, v in lora.items())
        assert changed == (i == 3)  # untouched until the last micro-step
    for key in lora:
        torch.testing.assert_close(lora[key], one.lora[key], rtol=1e-4, atol=1e-6)
    _assert_adapters_close(lora, want_lora)


def test_clip_follows_optax():
    """optax clips to g / norm * max_norm, torch's clip_grad_norm_ to g *
    max_norm / (norm + 1e-6): Adam's first moment after one step holds the
    clipped gradient times (1 - b1)."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # norm 13
    p = [torch.zeros(2, requires_grad=True), torch.zeros(1, requires_grad=True)]
    opt = tstep.make_optimizer(lr=1e-3, weight_decay=0.0, clip_norm=1.0)
    state = opt.init(dict(zip("ab", p)))
    opt.update(g, state)
    clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x.numpy()) for x in g],
                                                        optax.EmptyState())
    for param, want in zip(p, clipped):
        got = state.adamw.state[param]["exp_avg"] / (1 - 0.9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


class _Recorder(torch.nn.Module):
    """Records the conditions it is given; predicts zeros."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.seen = []

    def forward(self, noisy, text, t, inpaint_latents=None, cross_latents=None,
                image_rotary_emb=None):
        self.seen.append((text, cross_latents, inpaint_latents))
        return noisy * self.w


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_dropout_masks_one_condition_per_sample(setup, p):
    rng = np.random.default_rng(9)
    batch = _batch(rng, 32)
    model = _Recorder()
    fn = tstep.make_loss_fn(model, setup["tsched"], setup["tstate"], cfg_dropout_prob=p)
    fn(None, batch, torch.Generator().manual_seed(3))
    kept = []
    for got, name in zip(model.seen[0], ("prompt_embeds", "ref_latents", "inpaint_latents")):
        x = torch.as_tensor(batch[name])
        per_sample = [bool(torch.equal(g, s)) for g, s in zip(got, x)]
        zero = [not g.any() for g in got]
        assert all(a or z for a, z in zip(per_sample, zero))  # whole samples only
        kept.append(per_sample)
    if p == 0.0:
        assert all(all(k) for k in kept)
    elif p == 1.0:
        assert not any(any(k) for k in kept)
    else:
        assert all(0 < sum(k) < 32 for k in kept)
        assert kept[0] != kept[1] or kept[1] != kept[2]  # three independent masks


# ----------------------------------------------------------------------------
# validation and data
# ----------------------------------------------------------------------------


def test_depth_metrics_match_jax():
    rng = np.random.default_rng(10)
    pred = rng.uniform(0, 1, (4, 6, 8, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (4, 6, 8, 3)).astype(np.float32)
    pred[0, 0, 0] = 0.0
    masks = rng.uniform(0, 255, (4, 6, 8)).astype(np.float32)
    want = jval.depth_error_metrics(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(masks))
    got = tval.depth_error_metrics(torch.as_tensor(pred), torch.as_tensor(gt),
                                   torch.as_tensor(masks))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    d = np.array([0.0, 0.5, 1.0], np.float32)
    np.testing.assert_allclose(tval.unnormalize_depth(torch.as_tensor(d)).numpy(),
                               np.asarray(jval.unnormalize_depth(jnp.asarray(d))))
    empty = torch.zeros((2, 2), dtype=torch.bool)
    assert np.isnan(float(tval.relative_depth_error(torch.ones(2, 2), torch.ones(2, 2), empty)))


def test_run_validation_matches_jax(setup):
    """Three held-out samples, stratified timesteps, noise supplied."""
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        b = _batch(rng, 1)
        del b["timesteps"]
        batches.append(b)
    jeval = jax.jit(jval.make_eval_loss(setup["jmodel"], setup["params"], setup["jsched"],
                                        setup["jstate"], lora_alpha=ALPHA, lora_rank=RANK))
    want = jval.run_validation(jeval, _jax_lora(setup["lora"]), batches, seed=4)
    model = _port_model(setup["params"], attention_impl="flash_stock", remat=True)
    teval = tval.make_eval_loss(model, setup["tsched"], setup["tstate"], lora_alpha=ALPHA,
                                lora_rank=RANK)
    got = tval.run_validation(teval, _port_lora(setup["lora"]), batches, seed=4)
    assert got["val_samples"] == want["val_samples"] == 3
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=LOSS_RTOL)


def test_sanity_dump_and_metrics_logger_match_jax(tmp_path):
    batch = _batch(np.random.default_rng(12), 2)
    assert tval.sanity_check_batch(batch, 3) == jval.sanity_check_batch(batch, 3)
    paths = {side: str(tmp_path / side / "m.jsonl") for side in ("jax", "port")}
    for side, mod in (("jax", jval), ("port", tval)):
        log = mod.MetricsLogger(paths[side], tensorboard=False)
        log.log(1, loss=0.5, vec=np.array([1.0, 2.0]))
        log.log(2, val_loss=np.float32(0.25), val_samples=3)
        log.close()
    strip = lambda path: [{k: v for k, v in json.loads(line).items() if k != "time"}
                          for line in open(path)]
    assert strip(paths["port"]) == strip(paths["jax"])
    port = tval.MetricsLogger(str(tmp_path / "t" / "m.jsonl"), tensorboard=False)
    port.log(1, loss=torch.tensor(0.5))
    assert json.loads(open(tmp_path / "t" / "m.jsonl").read())["loss"] == 0.5


def test_latents_dataset_split_and_batches_match_jax(tmp_path):
    rng = np.random.default_rng(13)
    for i in range(7):
        save_latent_sample(str(tmp_path / f"s{i:02d}.npz"),
                           gt_latents=rng.standard_normal((2, 2, 2, 1)).astype(np.float32),
                           index=np.array([i]))
    port, jax_ds = LatentsDataset(str(tmp_path)), JaxLatentsDataset(str(tmp_path))
    assert port.files == jax_ds.files
    (pt, pv), (jt, jv) = port.split(0.3, seed=5), jax_ds.split(0.3, seed=5)
    assert (pt.files, pv.files) == (jt.files, jv.files) and len(pv) == 2
    got = [b["index"].tolist() for b in pt.iter_batches(2, seed=3, epochs=3)]
    want = [b["index"].tolist() for b in jt.iter_batches(2, seed=3, epochs=3)]
    assert got == want and len(got) == 6
    with pytest.raises(ValueError, match="exceeds dataset size"):
        pv.iter_batches(3)


# ----------------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------------


def test_train_lora_main_validates_checkpoints_and_resumes(tmp_path):
    from safetensors import safe_open

    from trajectorycrafter_tpu_torch.scripts import train_lora

    rng = np.random.default_rng(14)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(4):
        save_latent_sample(str(data / f"sample_{i:06d}.npz"),
                           gt_latents=rng.standard_normal((2, 4, 4, 4)).astype(np.float32),
                           ref_latents=rng.standard_normal((1, 4, 4, 4)).astype(np.float32),
                           inpaint_latents=rng.standard_normal((2, 4, 4, 5)).astype(np.float32),
                           prompt_embeds=rng.standard_normal((3, 8)).astype(np.float32))
    out = tmp_path / "out"
    argv = ["--data_dir", str(data), "--output_dir", str(out), "--train_steps", "2",
            "--validate_every", "1", "--checkpointing_steps", "1", "--log_every", "1",
            "--val_fraction", "0.25", "--learning_rate", "1e-2"]
    assert len(train_lora.get_parser()._actions) == 19 + 1 + 1  # --dist_backend and -h
    state = train_lora.main(argv, device="cpu")
    assert state.step == 2
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    assert [r["val_samples"] for r in recs if "val_loss" in r] == [1, 1]
    assert all(np.isfinite(r.get("loss", r.get("val_loss"))) for r in recs)
    assert sorted(os.listdir(out)) == ["ckpt_0000001", "ckpt_0000002", "lora_final",
                                       "metrics.jsonl"] + (["tb"] if (out / "tb").exists() else [])
    with safe_open(str(out / "ckpt_0000002" / "lora.safetensors"), framework="pt") as f:
        assert f.metadata()["step"] == "2"
        saved = {k: f.get_tensor(k) for k in f.keys()}
    assert len(saved) == 2 * (4 * 6 + 2 * 3 + 1)  # 4 blocks, 2 Perceivers, proj_out
    assert any(v.any() for k, v in saved.items() if "lora_B" in k)
    for key, value in state.lora.items():
        torch.testing.assert_close(saved[key], value.detach())

    resumed = train_lora.main(argv[:4] + ["--train_steps", "3", "--resume_from_checkpoint",
                                          "latest", "--checkpointing_steps", "1",
                                          "--log_every", "1"], device="cpu")
    assert resumed.step == 3
    assert (out / "ckpt_0000003").is_dir()
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert recs[-1]["step"] == 3 and np.isfinite(recs[-1]["loss"])
    # the resumed run started from step 2's adapters: one AdamW step from them
    moved = [(resumed.lora[k].detach() - saved[k]).abs().max().item() for k in saved]
    assert 0 < max(moved) <= 1e-2 * 1.01
