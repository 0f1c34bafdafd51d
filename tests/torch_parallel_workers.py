"""The ranks' side of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_ring_attention.py): functions that ``torch_worlds.run_world``
runs in each rank of a gloo world on the CPU.  No jax here: the ranks
import the port only."""

import warnings
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel, FeedForward
from trajectorycrafter_tpu_torch.ops import int8_matmul as im
from trajectorycrafter_tpu_torch.ops import ring_attention as ra
from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear, quantize_dit_
from trajectorycrafter_tpu_torch.orchestrator import (
    TrajCrafter,
    build_dev_models,
    build_dit,
)
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh
from trajectorycrafter_tpu_torch.parallel.sharding import (
    shard_dit_,
    shard_linear,
    shard_sizes,
    shard_state_dict,
)
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax

T = torch.from_numpy


def _mesh(shape):
    with warnings.catch_warnings():  # a mesh smaller than the world idles the rest
        warnings.simplefilter("ignore")
        return make_mesh(*shape, device="cpu")


def sharded_dit(params, dims: dict, mesh, quant: bool) -> CrossTransformer3DModel:
    """The tiny DiT of ``dims`` sharded over ``mesh``, holding this rank's
    tensor-parallel shard of the JAX tree ``params`` (unquantized or int8),
    loaded through the weight bridge."""
    with torch.device("meta"):
        model = CrossTransformer3DModel(**dims)
    if quant:
        quantize_dit_(model)
    shard_dit_(model, mesh)
    model.to_empty(device="cpu")
    model.load_state_dict(dit_from_jax(params, mesh.tp.size, mesh.tp.index), strict=True)
    return model.eval()


def dit_forwards(rank, shapes, models, dims, args, rope):
    """For each mesh shape, each model of ``models`` ({name: (JAX params,
    int8)}) sharded over it on the whole inputs ``args``: this rank's output
    (None where the mesh leaves it idle), the text rows it holds at the
    final norm, its coordinates and head counts; and ``build_dit``'s shard
    of seeded weights against the shard of the whole model's."""
    out = {}
    for shape in shapes:
        mesh = _mesh(shape)
        if not mesh.member:
            continue
        for name, (params, quant) in models.items():
            model = sharded_dit(params, dims, mesh, quant)
            text_rows = []  # the text stream this rank holds after the last block
            model.transformer_blocks[-1].register_forward_hook(
                lambda mod, inp, outp: text_rows.append(outp[1]))
            with torch.no_grad():
                y = model(*(None if a is None else T(a) for a in args),
                          image_rotary_emb=tuple(T(t) for t in rope))
            out[shape, name] = {
                "out": y.numpy(), "text_rows": text_rows[0].numpy(),
                "coords": (mesh.dp.index, mesh.sp.index, mesh.tp.index),
                "heads": (model.transformer_blocks[0].attn1.heads,
                          model.perceiver_cross_attention[0].heads)}
        make = lambda: CrossTransformer3DModel(**dims)
        whole = build_dit(make, "cpu", torch.float32, 5, "int8")
        shard = shard_dit_(build_dit(make, "cpu", torch.float32, 5, "int8", mesh.tp), mesh,
                           units_done=True)
        want = shard_state_dict(whole.state_dict(), mesh.tp.size, mesh.tp.index)
        got = shard.state_dict()
        out[shape, "build_dit"] = set(got) == set(want) and all(
            torch.equal(got[k], want[k]) for k in want)
    return out


def ring_cases(rank, cases, fault=False):
    """Each case (sp, q, k, v, scale): this rank's rows of the ring
    attention over (B, H, S, D), its sp coordinate; None where idle.
    ``fault``: merge the partials with equal weights (the lse ignored)."""
    out = []
    patch = (mock.patch.object(ra, "_combine", lambda o1, l1, o2, l2: ((o1 + o2) / 2, l1))
             if fault else mock.patch.object(ra, "_combine", ra._combine))
    with patch:
        for sp, q, k, v, scale in cases:
            mesh = _mesh((1, sp, 1))
            if not mesh.member:
                out.append(None)
                continue
            sizes = shard_sizes(q.shape[2], sp)
            lo = sum(sizes[:mesh.sp.index])
            part = lambda x: T(x[:, :, lo:lo + sizes[mesh.sp.index]].copy())
            o = ra.ring_attention(part(q), part(k), part(v), mesh.sp, q.shape[2], scale)
            out.append((mesh.sp.index, o.numpy()))
    return out


def row_parallel(rank, x, ff_weights, ff_x):
    """Under tp 2 and 4: the row-parallel int8 layer's codes and scales of
    this rank's columns of x, with the row max reduced over tp and, as a
    planted fault, without; and under tp 2 the fused int8 feed-forward
    (``ff_weights``: a FeedForward's state dict) on ``ff_x``."""
    out = {}
    for shape in ((1, 1, 4), (2, 1, 2)):
        mesh = _mesh(shape)
        tp = mesh.tp.size
        x_l = T(x).chunk(tp, dim=1)[mesh.tp.index].contiguous()
        local = x_l.abs().amax(dim=1).float()
        xs = im.row_scales(D.all_reduce(local.clone(), mesh.tp, op="max"))
        xs_fault = im.row_scales(local)
        out[tp] = (mesh.tp.index, im.quantize_rows_scaled(x_l, xs).numpy(), xs.numpy(),
                   im.quantize_rows_scaled(x_l, xs_fault).numpy())
    mesh = _mesh((2, 1, 2))
    ff = FeedForward(ff_x.shape[-1])
    ff.load_state_dict({k: T(v) for k, v in ff_weights.items()})
    ff.net[0].proj = shard_linear(Int8Linear.from_linear(ff.net[0].proj), "col", mesh.tp)
    ff.net[2] = shard_linear(Int8Linear.from_linear(ff.net[2]), "row", mesh.tp)
    ff.fuse = True
    with torch.no_grad():
        out["ff"] = ff(T(ff_x)).numpy()
    return out


def denoise(rank, shape, cases, pipe_args, seed):
    """For each case (a sampler and the leader's sampling arguments), a
    denoise of the tiny dev pipeline sharded over ``shape``: the final
    latents and the latents after each step, on every rank.  Every rank
    passes the conditioning videos; only the leader passes the prompt
    embeddings and the sampling arguments."""
    mesh = _mesh(shape)
    return {name: _denoise(mesh, shape, sampler, kwargs, pipe_args, seed)
            for name, (sampler, kwargs) in cases.items()}


def _denoise(mesh, shape, sampler, kwargs, pipe_args, seed):
    from trajectorycrafter_tpu_torch.config import TrajCrafterConfig

    cfg = TrajCrafterConfig()
    cfg.diffusion.sampler_name = sampler
    cfg.diffusion.quant = "none"
    cfg.parallel.dp, cfg.parallel.sp, cfg.parallel.tp = shape
    tc = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu", seed=seed), mesh=mesh)
    pipe = tc.models.pipeline
    steps, finals = [], []
    step = pipe.scheduler.step

    def recorded(*a, **kw):
        res = step(*a, **kw)
        lat = res[0] if isinstance(res, tuple) else res
        steps.append(lat.clone())
        return res

    pipe.scheduler.step = recorded
    denoise_loop = pipe._denoise
    pipe._denoise = lambda *a, **kw: finals.append(denoise_loop(*a, **kw)) or finals[-1]
    pe, ne, video, mask, reference = (T(a) for a in pipe_args)
    with torch.no_grad():
        if mesh.leader:
            pipe(pe, ne, video, mask, reference, generator=torch.Generator().manual_seed(7),
                 output_type="latent", **kwargs)
        else:
            pipe(None, None, video, mask, reference)
    return {"final": finals[0].numpy(), "steps": [s.numpy() for s in steps]}


# ----------------------------------------------------------------------------
# the sharded warp and VAE (tests/test_torch_spatial.py)
# ----------------------------------------------------------------------------


def _splat_counter():
    """A patch of ``splat.bilinear_splat`` that records the frames each
    call splats."""
    from trajectorycrafter_tpu_torch.ops import splat

    seen, real = [], splat.bilinear_splat

    def counted(values, *a, **kw):
        seen.append(values.shape[0])
        return real(values, *a, **kw)

    return seen, mock.patch.object(splat, "bilinear_splat", counted)


def _transport_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in D.TRANSPORT.items() if v != before.get(k, 0)}


def _vae_pipeline(vae_weights, mesh):
    """The tiny dev pipeline, fp32, its VAE holding ``vae_weights``,
    sharded over ``mesh`` (None: unsharded)."""
    from trajectorycrafter_tpu_torch.config import TrajCrafterConfig

    cfg = TrajCrafterConfig()
    cfg.diffusion.quant = "none"
    pipe = build_dev_models(cfg, "cpu").pipeline
    pipe.vae.load_state_dict({k: T(v) for k, v in vae_weights.items()}, strict=True)
    return pipe if mesh is None else pipe.with_mesh(mesh)


# the planted faults of the sharded VAE: every halo zero (each slab padded
# as if its edges were the image's), every GroupNorm on its slab's statistics
SPATIAL_FAULTS = {
    "zero halo": ("halo", lambda x, plane, t, b, l, r: F.pad(x, (l, r, t, b))),
    "local norm": ("group_norm", lambda norm, x, plane: F.group_norm(
        x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
        norm.eps).to(x.dtype)),
}


def spatial(rank, warp_cases, vae_weights, vae_cases, fault_case, gradual, strips):
    """The sharded warp on each of ``warp_cases`` (whole inputs; 4 ranks,
    every mesh axis), every rank's outputs and the frames it splatted; the sharded
    condition prep and decode of each of ``vae_cases`` ({name: (mesh shape,
    video, mask, reference, ref noise, aug noise, latents)}), with the
    transport and this rank's coordinates and slabs; the same under each of
    ``SPATIAL_FAULTS`` on ``fault_case``; ``gradual`` (argv, warp size,
    mesh shape): a sharded ``infer_gradual`` of the dev stack; ``strips``
    (latents, memory, strip height, {name: mesh shape}): ``vae_decode_auto``
    on the sharded twin of each mesh with that memory, and the tiles it
    decoded."""
    from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
    from trajectorycrafter_tpu_torch.parallel import spatial as S

    out = {}
    mesh = _mesh((2, 2, 1))
    seen, counting = _splat_counter()
    with counting, torch.no_grad():
        out["warp"] = {(name, clean): [x.numpy() for x in forward_warp_batch(
            *map(T, case), use_mask_clean=clean, mesh=mesh)]
            for name, case in warp_cases.items() for clean in (False, True)}
    out["warp_frames"] = list(seen)

    def conditions_and_decode(pipe, case):
        video, mask, ref, ref_noise, aug_noise, z = map(T, case)
        inpaint, ref_lat = pipe.prepare_conditions(video, mask, ref,
                                                   noise_override=(ref_noise, aug_noise))
        return [inpaint.numpy(), ref_lat.numpy(), pipe.decode(z).numpy()]

    for name, (shape, *case) in vae_cases.items():
        mesh = _mesh(shape)
        pipe = _vae_pipeline(vae_weights, mesh)
        before = dict(D.TRANSPORT)
        got = conditions_and_decode(pipe, case)
        plane = pipe.spatial_vae.plane
        out[name] = {"outputs": got, "transport": _transport_since(before),
                     "coords": (mesh.dp.index, mesh.sp.index, mesh.tp.index),
                     "plane": plane.both.ranks,
                     "latent_slab": tuple(plane.slab(T(case[-1]).permute(0, 4, 1, 2, 3),
                                                     1).shape[3:])}
    shape, *case = vae_cases[fault_case]
    pipe = _vae_pipeline(vae_weights, _mesh(shape))
    for fault, (attr, fake) in SPATIAL_FAULTS.items():
        with mock.patch.object(S, attr, fake):
            out[fault] = conditions_and_decode(pipe, case)

    from trajectorycrafter_tpu_torch.models import vae as vae_mod

    z, memory, strip_height, meshes = strips
    decode = vae_mod.vae_decode
    for name, shape in meshes.items():
        pipe = _vae_pipeline(vae_weights, _mesh(shape))
        tiles = []
        with mock.patch.object(vae_mod, "vae_decode",
                               lambda vae, x: tiles.append(x.shape[2:4]) or decode(vae, x)), \
                torch.no_grad():
            got = vae_mod.vae_decode_auto(pipe.spatial_vae, T(z), memory, strip_height)
        out[f"strips {name}"] = {"video": got.numpy(), "tiles": tiles}

    argv, warp_size, shape = gradual
    from trajectorycrafter_tpu_torch.cli import parse_config

    cfg = parse_config(argv)
    cfg.warp_size = warp_size
    cfg.parallel.dp, cfg.parallel.sp, cfg.parallel.tp = shape
    mesh = _mesh(shape)
    tc = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu"), mesh=mesh)
    seen, counting = _splat_counter()
    before = dict(D.TRANSPORT)
    with counting:
        gen = tc.infer_gradual()
    out["gradual"] = {"gen": gen, "transport": _transport_since(before),
                      "warp_frames": list(seen), "stages": sorted(tc.timer.seconds)}
    return out


# ----------------------------------------------------------------------------
# the sharded depth stage (tests/test_torch_depth_sharded.py)
# ----------------------------------------------------------------------------


def _depth_stage_models(weights, quant: bool = False):
    """The tiny DepthCrafter UNet, SVD VAE and (where ``weights`` has one)
    CLIP of ``weights`` ({"unet" | "vae" | "clip": state dict, "dims": the
    constructors' arguments}), fp32; the UNet's transformers int8 under
    ``quant``."""
    from trajectorycrafter_tpu_torch.models.clip import CLIPVisionModelWithProjection
    from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
    from trajectorycrafter_tpu_torch.models.svd_vae import AutoencoderKLTemporalDecoder
    from trajectorycrafter_tpu_torch.ops.int8 import quantize_depth_unet_

    def load(module, name):
        module.load_state_dict({k: T(v) for k, v in weights[name].items()}, strict=True)
        return module.eval()

    dims = weights["dims"]
    unet = load(UNetSpatioTemporalConditionModel(**dims["unet"]), "unet")
    if quant:
        quantize_depth_unet_(unet)
    vae = load(AutoencoderKLTemporalDecoder(**dims["vae"]), "vae")
    clip = load(CLIPVisionModelWithProjection(**dims["clip"]), "clip") if "clip" in weights \
        else None
    return unet, vae, clip


def _zero_pad(x, *pads):
    return F.pad(x, [p for pair in pads for p in pair])


# the planted faults of the sharded depth stage, each (where, name, fake): a
# zero row halo (each slab padded as if its rows were the picture's top and
# bottom), a zero frame halo, every GroupNorm on its slab's statistics, the
# temporal transformers' frame ids counted from the slab's first frame, the
# self-attention's keys and values left the rank's own
DEPTH_FAULTS = {
    "zero row halo": ("frames", "row_halo", lambda x, slab, above, below: _zero_pad(
        x, (0, 0), (0, 0), (above, below))),
    "zero frame halo": ("frames", "frame_halo", lambda x, slab, before, after: _zero_pad(
        x, (0, 0), (0, 0), (0, 0), (before, after))),
    "local norm": ("frames", "group_norm", lambda norm, x, axis: _depth_group_norm(norm, x)),
    "local frame ids": ("Slab", "frame_ids", lambda slab, device: torch.arange(
        slab.num_frames, dtype=torch.float32, device=device)),
    "K/V ungathered": ("frames", "gather_kv", lambda kv, axis, sizes: kv),
}


def _depth_group_norm(norm, x):
    from trajectorycrafter_tpu_torch.models.depthcrafter import group_norm_cl

    return group_norm_cl(norm, x)


def planted_depth_fault(name):
    """A context that plants ``DEPTH_FAULTS[name]`` in this rank's modules."""
    from trajectorycrafter_tpu_torch.parallel import frames as FR

    where, attr, fake = DEPTH_FAULTS[name]
    return mock.patch.object(FR if where == "frames" else FR.Slab, attr, fake)


def sharded_unet_forward(unet, mesh, args) -> dict:
    """The UNet's sharded twin over ``mesh`` on this rank's slab of the whole
    ``args`` (sample, timestep, CLIP embeddings, added time ids), its output
    joined whole; with the collectives it made and its slab."""
    from trajectorycrafter_tpu_torch.parallel.frames import FrameRows
    from trajectorycrafter_tpu_torch.parallel.spatial import shard_spatially

    twin = shard_spatially(unet, FrameRows.of(mesh))
    sample, t, ehs, added = (T(a) for a in args)
    height = sample.shape[2]
    slab = twin.plane.layout(ehs.shape[1], height)
    before = dict(D.TRANSPORT)
    with torch.no_grad():
        y = twin(slab.take(sample, 1, 2), t, ehs, added, height=height)
    transport = _transport_since(before)
    return {"out": slab.join(y.contiguous(), 1, 2).numpy(), "transport": transport,
            "slab": (slab.num_frames, slab.num_rows),
            "coords": (mesh.dp.index, mesh.sp.index, mesh.tp.index)}


def depth_sharded(rank, weights, unet_cases, pipe_cases, fault_case, gradual):
    """The sharded depth stage of tests/test_torch_depth_sharded.py on the
    tiny models of ``weights``: the UNet's sharded forward on each of
    ``unet_cases`` ({name: (mesh shape, int8, args)}) and under each of
    ``DEPTH_FAULTS`` on ``fault_case``; the sharded pipeline on each of
    ``pipe_cases`` ({name: (mesh shape, int8, with CLIP, frames, keyword
    arguments)}) with the collectives it made; ``gradual`` (argv, warp size,
    mesh shape): a sharded ``infer_gradual`` with the tiny depth stage."""
    from trajectorycrafter_tpu_torch.orchestrator import depth_stage
    from trajectorycrafter_tpu_torch.pipelines.depth import DepthCrafterPipeline

    out = {"unet": {}, "faults": {}, "pipe": {}}
    for name, (shape, quant, args) in unet_cases.items():
        mesh = _mesh(shape)
        out["unet"][name] = sharded_unet_forward(_depth_stage_models(weights, quant)[0], mesh,
                                                 args)
    shape, quant, args = unet_cases[fault_case]
    mesh, unet = _mesh(shape), _depth_stage_models(weights, quant)[0]
    for fault in DEPTH_FAULTS:
        with planted_depth_fault(fault):
            out["faults"][fault] = sharded_unet_forward(unet, mesh, args)["out"]
    for name, (shape, quant, with_clip, frames, kwargs) in pipe_cases.items():
        unet, vae, clip = _depth_stage_models(weights, quant)
        pipe = DepthCrafterPipeline(unet=unet, vae=vae, image_encoder=clip if with_clip else None,
                                    dtype=torch.float32).with_mesh(_mesh(shape))
        before = dict(D.TRANSPORT)
        raw = pipe(frames, **kwargs)
        out["pipe"][name] = {"raw": raw, "transport": _transport_since(before)}

    argv, warp_size, shape = gradual
    from trajectorycrafter_tpu_torch.cli import parse_config

    cfg = parse_config(argv)
    cfg.warp_size = warp_size
    cfg.parallel.dp, cfg.parallel.sp, cfg.parallel.tp = shape
    models = build_dev_models(cfg, "cpu")
    unet, vae, clip = _depth_stage_models(weights)
    models.depth_infer = depth_stage(unet, vae, clip, torch.float32)
    depths = []
    infer = models.depth_infer
    tc = TrajCrafter(cfg, models=models, mesh=_mesh(shape))
    before = dict(D.TRANSPORT)
    tc.models.depth_infer = lambda *a, **kw: depths.append(infer(*a, **kw)) or depths[-1]
    gen = tc.infer_gradual()
    out["gradual"] = {"gen": gen, "depth": depths[0], "transport": _transport_since(before),
                      "stages": sorted(tc.timer.seconds),
                      "sharded": infer.__self__.pipe.mesh is not None}
    return out


# ----------------------------------------------------------------------------
# the GPipe block stack (tests/test_torch_pipeline_parallel.py)
# ----------------------------------------------------------------------------


def pipeline_stages(rank, meshes, cases, dims, inputs):
    """For each case (mesh shape, JAX params, int8, remat, rope, microbatches)
    the GPipe block stack of the tiny DiT ``dims`` over that mesh of
    ``meshes`` on ``inputs`` (hidden, encoder, temb, cross, rope): this
    rank's (hidden, encoder), the blocks it still holds on its device, its
    (tp, pp) coordinates and the bytes its hops sent; None where idle."""
    from trajectorycrafter_tpu_torch.parallel.pipeline import (
        pipeline_dit_blocks,
        stack_superblock_params,
        stacked_param_sharding,
    )

    built = {shape: _mesh(shape) for shape in meshes}
    hidden, encoder, temb, cross, rope = inputs
    out = {}
    for name, (shape, params, quant, remat, use_rope, m) in cases.items():
        mesh = built[shape]
        if not mesh.member:
            continue
        model = CrossTransformer3DModel(**dims, remat=remat)
        if quant:
            quantize_dit_(model)
        model.load_state_dict(dit_from_jax(params), strict=True)
        stages = stack_superblock_params(model.eval(), mesh.pp.size, mesh.pp.index)
        stacked_param_sharding(model, stages, mesh)
        before = D.TRANSPORT["stage direct bytes"]
        with torch.no_grad():
            h, e = pipeline_dit_blocks(model, stages, T(hidden), T(encoder), T(temb),
                                       tuple(map(T, rope)) if use_rope else None, T(cross),
                                       mesh, n_microbatches=m)
        out[name] = {"hidden": h.numpy(), "encoder": e.numpy(),
                     "held": [i for i, b in enumerate(model.transformer_blocks)
                              if not b.norm1.linear.weight.is_meta],
                     "coords": (mesh.tp.index, mesh.pp.index),
                     "hop_bytes": D.TRANSPORT["stage direct bytes"] - before}
    return out


# ----------------------------------------------------------------------------
# sharded LoRA training (tests/test_torch_training_sharded.py)
# ----------------------------------------------------------------------------


def _tp_function_grads(mesh, ff_weights, x, dout):
    """A feed-forward's gradients (input, first and second layer weights)
    with its layers sharded over ``mesh.tp``: sound, and with the
    column-input backward left unreduced (a planted fault)."""
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_linear

    out = {}
    for name in ("sound", "column input unreduced"):
        ff = FeedForward(x.shape[-1])
        ff.load_state_dict({k: T(v) for k, v in ff_weights.items()})
        ff.net[0].proj = shard_linear(ff.net[0].proj, "col", mesh.tp)
        ff.net[2] = shard_linear(ff.net[2], "row", mesh.tp)
        ff.tp_axis = mesh.tp
        weights = [ff.net[0].proj.weight, ff.net[2].weight]
        for w in weights:
            w.requires_grad_()
        xi = T(x).requires_grad_()
        patch = (mock.patch.object(D, "tp_input_grad", lambda g, axis: g)
                 if name != "sound" else mock.patch.object(D, "tp_input_grad", D.tp_input_grad))
        with patch:
            y = ff(xi)
            gx, g1, g2 = torch.autograd.grad(y, [xi, *weights], T(dout))
        out[name] = {"y": y.detach().numpy(), "x": gx.numpy(), "w1": g1.numpy(),
                     "w2": g2.numpy()}
    return out


def _tiny_training_model(params, dims, tp_axis):
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_units_

    model = CrossTransformer3DModel(**dims, attention_impl="flash_stock", remat=True)
    model.load_state_dict(dit_from_jax(params), strict=True)
    return shard_units_(model.eval(), tp_axis)


def _sharded_steps(mesh, params, dims, lora_np, case, batches):
    """Two steps of the sharded train step on ``batches``: per step the
    loss, grad norm and every adapter's checksum; the adapters at the end."""
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import step as tstep
    from trajectorycrafter_tpu_torch.utils.weights import lora_from_jax

    model = _tiny_training_model(params, dims, mesh.tp)
    sched = CogVideoXDDIMScheduler()
    opt = tstep.make_optimizer(lr=1e-3, grad_accum_steps=case["accum"])
    fn = tstep.make_train_step(model, sched, sched.set_timesteps(50), opt,
                               cfg_dropout_prob=case["dropout"],
                               motion_sub_loss=case["motion"], lora_alpha=case["alpha"],
                               lora_rank=case["rank"], mesh=mesh)
    lora = {k: v.requires_grad_() for k, v in lora_from_jax(lora_np).items()}
    state = tstep.TrainState(lora, opt.init(lora), 0)
    gen = torch.Generator().manual_seed(case["seed"])
    metrics, sums = [], []
    for b in batches:
        state, m = fn(state, b, gen)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        sums.append([float(v.detach().double().sum()) for v in lora.values()])
    return {"metrics": metrics, "sums": sums,
            "lora": {k: v.detach().numpy() for k, v in lora.items()}}


def _reduced_grads(mesh, params, dims, lora_np, case, batch, fault=None):
    """One batch's adapter gradients on this rank, reduced over the mesh;
    ``fault``: "proj_out summed over tp" or "dp summed"."""
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import step as tstep
    from trajectorycrafter_tpu_torch.utils.weights import lora_from_jax

    model = _tiny_training_model(params, dims, mesh.tp)
    sched = CogVideoXDDIMScheduler()
    fn = tstep.make_loss_fn(model, sched, sched.set_timesteps(50), cfg_dropout_prob=0.0,
                            lora_alpha=case["alpha"], lora_rank=case["rank"], dp=mesh.dp,
                            sp=mesh.sp if mesh.sp.size > 1 else None)
    lora = {k: v.requires_grad_() for k, v in lora_from_jax(lora_np).items()}
    grads = torch.autograd.grad(fn(lora, batch, 0), list(lora.values()))
    patches = {"proj_out summed over tp": mock.patch.object(
                   tstep, "tp_sharded_adapters", lambda model, names: set(names)),
               "dp summed": mock.patch.object(
                   tstep, "dp_mean", lambda flat, dp: D.sum_partials(flat, dp))}
    with patches.get(fault, mock.patch.object(tstep, "dp_mean", tstep.dp_mean)):
        reduced = tstep.reduce_lora_grads(grads, list(lora), model, mesh)
    return {k: g.numpy() for k, g in zip(lora, reduced)}


def _train_script(argv_train, argv_resume):
    """``scripts/train_lora.main`` in this world, then resumed from
    ``latest``: each call's final step, adapters and checkpoint writes.
    The metrics go to the jsonl alone (importing tensorboard takes rank 0
    ~20 s on the CPU)."""
    import sys

    from trajectorycrafter_tpu_torch.scripts import train_lora

    sys.modules["torch.utils.tensorboard"] = None
    out = {}
    for label, argv in (("train", argv_train), ("resume", argv_resume)):
        writes = []
        save = train_lora.save_lora
        with mock.patch.object(train_lora, "save_lora",
                               lambda path, lora, step: writes.append(step) or save(path, lora,
                                                                                    step)):
            state = train_lora.main(argv, device="cpu")
        out[label] = {"step": state.step, "writes": writes,
                      "lora": {k: v.detach().numpy() for k, v in state.lora.items()}}
    return out


def training_sharded(rank, ff_case, step_cases, grad_case, script_argv, tree):
    """The sharded training's rank side: the tp autograd Functions under tp
    2 (ranks 0-1), the train step's cases and the reduced gradients (sound
    and with planted faults) under dp 2 x tp 2, ``load_dit``'s shard of the
    tree ``tree`` (path, whole state dict), then the train script."""
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_state_dict
    from trajectorycrafter_tpu_torch.utils.checkpoints import load_dit

    out = {}
    tp2 = _mesh((1, 1, 2))
    if tp2.member:
        out["ff"] = _tp_function_grads(tp2, *ff_case)
    mesh = _mesh((2, 1, 2))
    out["coords"] = (mesh.dp.index, mesh.tp.index)
    out["steps"] = {name: _sharded_steps(mesh, *args) for name, args in step_cases.items()}
    out["grads"] = {fault: _reduced_grads(mesh, *grad_case, fault=fault)
                    for fault in (None, "proj_out summed over tp", "dp summed")}
    path, whole = tree
    got = load_dit(path, device="cpu", dtype=torch.float32, tp=mesh.tp).state_dict()
    want = shard_state_dict({k: T(v) for k, v in whole.items()}, mesh.tp.size, mesh.tp.index)
    out["load_dit"] = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    out["script"] = _train_script(*script_argv)
    return out


# ----------------------------------------------------------------------------
# the entry points under a mesh (tests/test_torch_entry_points_sharded.py)
# ----------------------------------------------------------------------------


def fp32_bundle(bundle):
    """``bundle`` (loaded in bf16) with every model and its pipeline in fp32,
    in place: a sharded run's reassociated sums stay within fp32 rounding of
    its unsharded twin's, where bf16 would round them up to visible changes."""
    from trajectorycrafter_tpu_torch.orchestrator import depth_pipeline

    pipe = bundle.pipeline
    pipe.vae.float(), pipe.transformer.float()
    pipe.dtype = torch.float32
    depth = depth_pipeline(bundle.depth_infer)
    if depth is not None:
        for model in (depth.unet, depth.vae, depth.image_encoder):
            if model is not None:
                model.float()
        depth.dtype = torch.float32
    if bundle.encode_prompt is not None:
        bundle.encode_prompt.t5.float()
    return bundle


def tiny_tree_patches(dims: dict, warp_size) -> None:
    """This rank's copy of tests/test_torch_scripts.py's patches (a spawned
    rank imports nothing of the test): the fixed-width constructors cut to
    ``dims`` ({module name: constructor arguments}), the VAE's key contract
    with them, a card that "is available" with the models built on the CPU
    and upcast to fp32 (``fp32_bundle``), the meshes made on the CPU and
    every script's config at ``warp_size``."""
    import functools

    from trajectorycrafter_tpu_torch import orchestrator
    from trajectorycrafter_tpu_torch.models import clip, depthcrafter, svd_vae, t5, vae
    from trajectorycrafter_tpu_torch.parallel import mesh
    from trajectorycrafter_tpu_torch.scripts import (
        autoregressive_global,
        inference_alignment,
        inference_autoregressive,
        inference_orbits,
        run_w_cam_poses,
    )
    from trajectorycrafter_tpu_torch.utils import checkpoints

    for module, name in ((vae, "AutoencoderKLCogVideoX"), (t5, "T5EncoderModel"),
                         (depthcrafter, "UNetSpatioTemporalConditionModel"),
                         (svd_vae, "AutoencoderKLTemporalDecoder"),
                         (clip, "CLIPVisionModelWithProjection")):
        setattr(module, name, functools.partial(getattr(module, name), **dims[name]))
    contract = dims["AutoencoderKLCogVideoX"]
    checkpoints.expected_vae_keys = functools.partial(
        checkpoints.expected_vae_keys, contract["block_out_channels"],
        contract["layers_per_block"])
    torch.cuda.is_available = lambda: True
    build = orchestrator.build_models
    orchestrator.build_models = lambda cfg, **kw: fp32_bundle(build(cfg, device="cpu", **kw))
    mesh.make_mesh = functools.partial(mesh.make_mesh, device="cpu")
    for script in (autoregressive_global, inference_alignment, inference_autoregressive,
                   inference_orbits, run_w_cam_poses):
        def at_warp_size(args, parse=script.config_from_args):
            cfg = parse(args)
            cfg.warp_size = warp_size
            return cfg

        script.config_from_args = at_warp_size


def _record_conditions(into: list):
    """A patch of ``TrajCrafter._diffuse_and_save`` (every subclass's) that
    records the conditions it is handed and the video it returns."""
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter

    real = TrajCrafter._diffuse_and_save

    def recorded(self, frames, cond_video, cond_masks, prompt, ref_slice=slice(0, None),
                 save_skip=0):
        gen = real(self, frames, cond_video, cond_masks, prompt, ref_slice, save_skip)
        into.append({"frames": np.asarray(frames), "cond": np.asarray(cond_video),
                     "masks": np.asarray(cond_masks), "ref_slice": ref_slice,
                     "save_skip": save_skip, "prompt": prompt, "gen": gen})
        return gen

    return mock.patch.object(TrajCrafter, "_diffuse_and_save", recorded)


def _record_depths(into: list):
    """A patch of ``TrajCrafter._estimate_depth`` (every subclass's depth
    stage) that records the depth each call returns."""
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter

    real = TrajCrafter._estimate_depth

    def recorded(self, frames):
        depth = real(self, frames)
        into.append(np.array(depth))
        return depth

    return mock.patch.object(TrajCrafter, "_estimate_depth", recorded)


def _record_steps(into: list):
    """A patch of the pipeline's denoise that records the latents each
    sampler step of its loop returns."""
    from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline

    real = TrajCrafterPipeline._denoise

    def denoise(self, *a, **kw):
        step = self.scheduler.step

        def recorded(*sa, **skw):
            res = step(*sa, **skw)
            into.append((res[0] if isinstance(res, tuple) else res).numpy().copy())
            return res

        self.scheduler.step = recorded
        try:
            return real(self, *a, **kw)
        finally:
            del self.scheduler.step

    return mock.patch.object(TrajCrafterPipeline, "_denoise", denoise)


def _files(root) -> list:
    from pathlib import Path

    root = Path(root)
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()) \
        if root.exists() else []


def _stub_bundle(caption: str = "a scene"):
    """The stub bundle of tests/test_torch_modes.py: the plane depth, a fixed
    caption, no pipeline but its device and timer (and a mesh it ignores)."""
    import types

    from trajectorycrafter_tpu_torch import orchestrator
    from trajectorycrafter_tpu_torch.utils.timing import StageTimer

    pipeline = types.SimpleNamespace(device=torch.device("cpu"), timer=StageTimer("cpu"),
                                     with_mesh=lambda mesh: None)
    return orchestrator.ModelBundle(pipeline=pipeline,
                                    depth_infer=orchestrator._plane_depth_infer,
                                    encode_prompt=None, get_caption=lambda frame: caption)


def _stub_runs(rank: int, stubs: dict, mesh_shape) -> dict:
    """v1 and the known-camera modes on the stub bundle under the mesh, with
    ``_diffuse_and_save`` recorded and answering each segment with the
    given video: the conditions each call is handed, and what it returns."""
    from trajectorycrafter_tpu_torch import autoregressive, known_poses
    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.config import TrajCrafterConfig

    out = {}

    def recording(tc, gen, calls):
        def recorded(frames, cond_video, cond_masks, prompt, ref_slice=slice(0, None),
                     save_skip=0):
            calls.append({"frames": np.asarray(frames), "cond": np.asarray(cond_video),
                          "masks": np.asarray(cond_masks), "prompt": prompt,
                          "ref_slice": ref_slice, "save_skip": save_skip})
            return gen

        tc._diffuse_and_save = recorded

    argv, warp_size, run, gen = stubs["v1"]
    cfg = parse_config(argv)
    cfg.warp_size = warp_size
    cfg.parallel.dp, cfg.parallel.sp, cfg.parallel.tp = mesh_shape
    tc = autoregressive.TrajCrafterAutoregressive(cfg, models=_stub_bundle())
    calls = []
    recording(tc, gen, calls)
    out["v1"] = {"calls": calls, "video": tc.infer_autoregressive(**run)}

    (frames, target_frames, depths, src, tgt), (f, h, w), save_dir, gen = stubs["known"]
    for label, smooth, given in (("fixed", False, True), ("smooth", True, False)):
        cfg = TrajCrafterConfig()
        cfg.video_length, cfg.warp_size, cfg.diffusion.sample_size = f, (h, w), (32, 48)
        cfg.parallel.dp, cfg.parallel.sp, cfg.parallel.tp = mesh_shape
        cfg.save_dir = f"{save_dir}/{label}/rank{rank}"
        tc = known_poses.CameraPoseTrajCrafter(cfg, models=_stub_bundle())
        calls = []
        recording(tc, gen, calls)
        cams = [known_poses.CalibratedCamera(**c) for c in (src, tgt)]
        d = depths if given else None
        if smooth:
            _, metrics = tc.infer_camera_poses_smooth(frames, d, *cams,
                                                      target_frames=target_frames)
        else:
            tc.infer_camera_poses(frames, d, *cams)
            metrics = None
        out[f"known {label}"] = {"calls": calls, "metrics": metrics,
                                 "files": _files(cfg.save_dir)}
    return out


def entry_points(rank, dims, warp_size, scripts, stubs, mesh_shape):
    """Each of ``scripts`` ({name: (module name, argv)}) through its
    ``main(argv)`` in this world, with the tiny-tree patches, this rank's
    ``--out_dir`` its own (``<out_dir>/rank<r>``): what main returns, the
    files this rank wrote, the conditions every ``_diffuse_and_save`` was
    handed, the latents of every sampler step, every depth the depth stage
    returned and the collectives; then the stub runs (``_stub_runs``)."""
    import importlib

    tiny_tree_patches(dims, warp_size)
    out = {}
    for name, (module, argv) in scripts.items():
        argv = list(argv)
        where = argv.index("--out_dir") + 1
        argv[where] = f"{argv[where]}/rank{rank}"
        main = importlib.import_module(f"trajectorycrafter_tpu_torch.scripts.{module}").main
        conditions, steps, depths = [], [], []
        before = dict(D.TRANSPORT)
        with _record_conditions(conditions), _record_steps(steps), _record_depths(depths):
            returned = main(argv)
        out[name] = {"returned": returned, "files": _files(argv[where]),
                     "conditions": conditions, "steps": steps, "depths": depths,
                     "transport": _transport_since(before)}
    out["stubs"] = _stub_runs(rank, stubs, mesh_shape)
    return out


def orbit_failure(rank, dims, warp_size, argv, failing_rank):
    """The orbit sweep under the mesh with the depth stage of its first
    variant failing on ``failing_rank`` alone: the exception ends that rank,
    and the collectives it no longer joins end the others."""
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter
    from trajectorycrafter_tpu_torch.scripts import inference_orbits

    tiny_tree_patches(dims, warp_size)
    if rank == failing_rank:
        def fail(self, frames):
            raise RuntimeError(f"planted depth failure on rank {rank}")

        TrajCrafter._estimate_depth = fail
    argv = list(argv)
    argv[argv.index("--out_dir") + 1] += f"/rank{rank}"
    return inference_orbits.main(argv)


# ----------------------------------------------------------------------------
# LoRA training with the token stream on sp (tests/test_torch_training_sp.py)
# ----------------------------------------------------------------------------


def ring_grads(mesh, cases):
    """For each case (S, q, k, v, dout, scale) of whole (B, H, S, D) arrays:
    this rank's rows of ``RingAttentionFunction``'s output and its dq, dk,
    dv of its shard, with its sp coordinate; None where the mesh idles it."""
    if not mesh.member:
        return None
    out = []
    for s, *arrays, scale in cases:
        sizes = shard_sizes(s, mesh.sp.size)
        lo, n = sum(sizes[:mesh.sp.index]), sizes[mesh.sp.index]
        q, k, v, dout = (T(x[:, :, lo:lo + n].copy()) for x in arrays)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ra.RingAttentionFunction.apply(q, k, v, mesh.sp, s, scale, False)
        grads = torch.autograd.grad(o, [q, k, v], dout)
        out.append([o.detach().numpy(), *(g.numpy() for g in grads)])
    return mesh.sp.index, out


class _GatherSummed(torch.autograd.Function):
    """The planted fault of the output's gather: backward the sum over sp of
    the ranks' gradients, then this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, dim, sizes):
        ctx.axis, ctx.dim, ctx.lo, ctx.n = axis, dim, sum(sizes[:axis.index]), sizes[axis.index]
        return D.all_gather(x, axis, dim=dim, sizes=sizes)

    @staticmethod
    def backward(ctx, grad):
        return (D.sum_partials(grad.contiguous(), ctx.axis).narrow(ctx.dim, ctx.lo, ctx.n),
                None, None, None)


def _own_queries_backward(sound):
    """The planted fault of the ring's backward: dq as ``sound`` gives it,
    dK / dV of the rank's own queries against its own shard only (the
    accumulators never travel)."""
    from trajectorycrafter_tpu_torch.ops.attention import attention_backward_reference

    def backward(ctx, dout):
        from types import SimpleNamespace

        saved = ctx.saved_tensors  # unpacked once (a recomputed block's may not be twice)
        dq, _, _, *rest = sound(SimpleNamespace(
            saved_tensors=saved, **{k: getattr(ctx, k) for k in ("axis", "s_true", "scale",
                                                                 "kernels_on")}), dout)
        q, k, v, out, lse = saved
        bshd = lambda x: x.transpose(1, 2)
        _, dk, dv = attention_backward_reference(bshd(q), bshd(k), bshd(v), bshd(out), lse,
                                                 bshd(dout), ctx.scale)
        return (dq, bshd(dk).to(k.dtype), bshd(dv).to(v.dtype), *rest)

    return backward


# the planted faults of sp training, by name -> the patch that plants it
SP_FAULTS = {
    "adapter gradients not summed over sp": lambda: mock.patch(
        "trajectorycrafter_tpu_torch.training.step.sp_sum", lambda flat, sp: flat),
    "output gather's backward summed over sp": lambda: mock.patch.object(
        D, "gather_tokens", lambda x, axis, dim, sizes: _GatherSummed.apply(
            x, axis, dim, list(sizes)) if axis.size > 1 else x),
    "ring backward keeps only its own queries' dK/dV": lambda: mock.patch.object(
        ra.RingAttentionFunction, "backward",
        staticmethod(_own_queries_backward(ra.RingAttentionFunction.backward))),
}


def training_sp(rank, ring_meshes, ring_cases_, step_cases, grad_case):
    """The sp training's rank side: ``RingAttentionFunction``'s gradients at
    each sp of ``ring_meshes`` on ``ring_cases_``; the train step's cases
    ({name: (mesh shape, params, dims, adapters, case, batches)}); one
    batch's reduced adapter gradients under ``grad_case``'s mesh, sound and
    with each of ``SP_FAULTS``."""
    out = {"ring": {sp: ring_grads(_mesh((1, sp, 1)), ring_cases_) for sp in ring_meshes}}
    out["steps"] = {}
    for name, (shape, *args) in step_cases.items():
        mesh = _mesh(shape)
        out["steps"][name] = _sharded_steps(mesh, *args)
    shape, *args = grad_case
    mesh = _mesh(shape)
    out["coords"] = (mesh.dp.index, mesh.sp.index, mesh.tp.index)
    out["grads"] = {None: _reduced_grads(mesh, *args)}
    for fault, patch in SP_FAULTS.items():
        with patch():
            out["grads"][fault] = _reduced_grads(mesh, *args)
    return out


# ----------------------------------------------------------------------------
# the worlds themselves (tests/test_torch_worlds.py)
# ----------------------------------------------------------------------------


def mesh_groups_and_decode(rank, shape, latents, memory):
    """The timeouts ``make_mesh`` gives its process groups; how many ranks
    of the mesh sit on this rank's device, by the real devices and by
    planted ones (each rank its own card); and the decode of the dev
    pipeline sharded over ``shape`` under a planted ``memory`` of the
    device: whether it took strips."""
    import torch.distributed as dist

    from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
    from trajectorycrafter_tpu_torch.models import vae as vae_mod
    from trajectorycrafter_tpu_torch.pipelines import trajcrafter

    real_group, timeouts = dist.new_group, []

    def group(*a, **kw):
        timeouts.append(kw.get("timeout"))
        return real_group(*a, **kw)

    with mock.patch.object(dist, "new_group", group):
        mesh = _mesh(shape)
    cfg = TrajCrafterConfig()
    cfg.diffusion.quant = "none"
    pipe = build_dev_models(cfg, "cpu").pipeline.with_mesh(mesh)
    routes, tiled = [], vae_mod.vae_decode_tiled
    with mock.patch.object(trajcrafter, "decode_memory_bytes", lambda device: memory), \
            mock.patch.object(vae_mod, "vae_decode_tiled",
                              lambda *a, **kw: routes.append("strips") or tiled(*a, **kw)):
        pipe.decode(T(latents))
    return {"timeouts": timeouts, "device_ranks": pipe.device_ranks, "routes": routes,
            "own_cards": D.ranks_on_device(mesh.world, f"cuda:{rank}")}
