#!/usr/bin/env python3
"""Readings that the limits of a denoise cell are set from, on the card:

    python3 benchmark/tools/calibrate.py --workload int8_384.denoise \\
        --seeds 1 2 3 --control-seeds 1 2 3 [--diagnose] [--witness 1]

For each seed: the program builds, runs one call of the window at the cell's
sizes, and is held against the reference (the cell's compared numbers:
``gap`` is ``update_rel_err``, ``guidance`` is ``guidance_err``; under int8
also ``guidance_own_term``, the projection on the int8 reference's own
guidance term).  On
each control seed the control, the reference one precision below the
configuration's (int4 under int8, fp8 under bf16), stands in the program's
place and is held against it the same way.  ``--diagnose`` adds the DiT's
two CFG branches and their difference against the reference's, before the
guidance combine;
``--witness`` runs the port's own plain path in float32 (plain attention,
plain int8 products) against the reference; ``--faults`` each fault of
benchmark/faults.py planted in the program.  One JSON line a reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.faults import planted  # noqa: E402
from benchmark.reference.dit import rope_tables  # noqa: E402
from benchmark.reference.step import ddim_origin_tables  # noqa: E402

CONTROL = {"int8": "int4", "none": "fp8"}


def emit(**row):
    print(json.dumps(row), flush=True)


def branches(driver, index):
    """(program's CFG branches, reference's) at call ``index``'s first step."""
    cfg, i = driver.cfg, driver.t_start
    x = driver.latents(index)
    t = float(ddim_origin_tables(cfg["num_inference_steps"])[0][i])
    text, inpaint, reference = driver.cfg_inputs
    with torch.no_grad():
        prog = driver.pipe.transformer(
            torch.cat([x, x]).to(driver.dtype), text, torch.full((2,), t, device=x.device),
            inpaint_latents=inpaint, cross_latents=reference,
            image_rotary_emb=driver.rope).float()
    return prog, x, t


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--diagnose", action="store_true")
    p.add_argument("--witness", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], help="faults planted, one run each")
    args = p.parse_args()
    harness.cache_dirs()
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg, mix = harness.config_of(bench, cell["config"]), harness.mix_of(cell["traffic"])
    driver_mod = harness.load_file(harness.BENCH_DIR / "drivers" / f"{mix['driver']}.py",
                                   "driver")
    for seed in args.seeds:
        t0 = time.perf_counter()
        d = driver_mod.Driver(cfg, mix, seed, "cuda")
        t_build = time.perf_counter() - t0
        d.call(0)
        torch.cuda.synchronize()
        diag = branches(d, 0) if args.diagnose else None
        d.release()
        t1 = time.perf_counter()
        model = d.reference_model()
        ref, own = d.follow(model, 0)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t1
        term = own if d.precision() == "fp32" else d.follow(d.reference_model("fp32"), 0)[1]

        def readings(out):
            row = d.readings(out, ref, term, 0)
            row = dict(gap=row["update_rel_err"], guidance=row["guidance_err"])
            if own is not term:  # on the configuration's own term, for the look
                row["guidance_own_term"] = d.guidance_gap(out, ref, own)
            return row

        emit(seed=seed, side="program", **readings(d.outputs[0]), build_s=t_build,
             reference_s=t_ref)
        if diag is not None:
            prog, x, t = diag
            f = d.latent_shape[1]
            rope = tuple(r.to(x.device) for r in rope_tables(
                cfg["attention_head_dim"], *cfg["sample_size"], f, cfg["patch_size"]))
            with torch.no_grad():
                refb = model.forward(torch.cat([x, x]), torch.cat([d.negative, d.text]),
                                     torch.full((2,), t, device=x.device),
                                     torch.cat([d.inpaint] * 2), torch.cat([d.reference] * 2),
                                     rope)
            rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
            emit(seed=seed, side="branches", uncond=rel(prog[0], refb[0]),
                 cond=rel(prog[1], refb[1]), ref_cond_minus_uncond=rel(refb[1], refb[0]),
                 cond_minus_uncond=rel(prog[1] - prog[0], refb[1] - refb[0]),
                 ref_out_rms=float(refb.pow(2).mean().sqrt()),
                 latent_rms=float(x.pow(2).mean().sqrt()))
        if seed in args.control_seeds:
            t1 = time.perf_counter()
            ctl, _ = d.follow(d.reference_model(CONTROL[cfg["quant"]]), 0)
            emit(seed=seed, side="control", precision=CONTROL[cfg["quant"]], **readings(ctl),
                 control_s=time.perf_counter() - t1)
        for name in args.faults:
            with planted(name):
                bad = driver_mod.Driver(cfg, mix, seed, "cuda")
                bad.call(0)
            emit(seed=seed, side="fault", fault=name, **readings(bad.outputs[0]))
            bad.release()
            del bad
        if seed in args.witness:
            wcfg = dict(cfg, dtype="float32", attention_impl="reference")
            w = driver_mod.Driver(wcfg, mix, seed, "cuda")
            for m in w.pipe.transformer.modules():
                if hasattr(m, "int8_impl"):
                    m.int8_impl = "reference"
            w.call(0)
            emit(seed=seed, side="witness", **readings(w.outputs[0]))
            w.release()
            del w
        del d, model, ref, own, term
    print(f"forbidden modules: {harness.forbidden_modules()}", file=sys.stderr)


if __name__ == "__main__":
    main()
