#!/usr/bin/env python3
"""Time this checkout's attention backward kernels against another checkout's on one card.

    python3 tools/flash_bwd_ab.py --parent DIR [--tree NAME=DIR ...]

Builds ``csrc/flash_attention_bwd.cu`` (K4-dkv ``flash_attention_bwd_dkv``
and K4-dq ``flash_attention_bwd_dq``) of this checkout ("change"), of the
checkout at DIR ("parent", e.g. the parent commit unpacked with ``git
archive`` into a directory ``.gitignore`` lists) and of any other trees
named, with the flags of ``ops/kernels.py``, and prints each tree's
registers and spill bytes per kernel as ptxas reports them.  The entry
points keep one signature across trees, so one set of argument types
serves all.  At the DiT's and the Perceiver's training shapes every tree's
dq, dk and dv are held to the plain version (``attention_backward_error``)
and compared bit for bit with the parent's (trees that sum in the same
order give the same bits), and the kernels are timed with CUDA events in turns (the trees in order,
then in reverse) beside flash SDPA's backward, which gives dq, dk and dv in
one call (the yardstick of each tree's two kernels together).  Prints the
card's name and power limit, a line per shape, and one JSON line.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

ITERS = 10
# (B, H, Sq, Skv, D, q gain): the DiT's joint self-attention in training (B
# = 1, QK-normed scores at init) and the Perceiver's cross-attention (no
# QK-norm: peaked rows)
SHAPES = {
    "dit": (1, 48, 13330, 13330, 64, 1.0),
    "perceiver": (1, 16, 13104, 3024, 128, 4.0),
}
KERNELS = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def ptxas_usage(log: str) -> dict:
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from an ``-Xptxas -v`` log, the kernel's mangled name cut to its
    template (``dkv_kernel<64>``)."""
    usage, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            m = re.search(r"([A-Za-z_]+_kernel)ILi(\d+)E", entry.group(1))
            name = f"{m.group(1)}<{m.group(2)}>" if m else entry.group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            usage[name] = f"{spill.group(1)} bytes spill stores, {spill.group(2)} bytes spill loads"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            usage[name] = f"{regs.group(1)} registers, " + usage.get(name, "")
    return usage


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="the checkout to compare with (its root directory)")
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: a further checkout to time beside the two")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="comma-separated names of SHAPES to run")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from chip_smoke import _backward_bound, in_turns
    from int8_gemm_ab import _launcher
    from trajectorycrafter_tpu_torch.bench_attention import sdpa_flash
    from trajectorycrafter_tpu_torch.ops import kernels
    from trajectorycrafter_tpu_torch.ops.attention import attention_backward_error, attention_di

    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ab: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.DEVICE["sm_clock_hz"] = float(clock.splitlines()[0]) * 1e6

    trees = {"parent": args.parent.resolve(), "change": REPO}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    runs, usage = {}, {}
    for name, root in trees.items():
        csrc = root / "trajectorycrafter_tpu_torch" / "csrc"
        dkv, _ = _launcher(csrc, "flash_attention_bwd_dkv", kernels._BWD_DKV_ARGTYPES,
                           source="flash_attention_bwd")
        dq, _ = _launcher(csrc, "flash_attention_bwd_dq", kernels._BWD_DQ_ARGTYPES,
                          source="flash_attention_bwd")
        usage[name] = ptxas_usage(kernels.build_library("flash_attention_bwd.cu", csrc)["log"])
        for kernel, text in usage[name].items():
            print(f"[{name}] ptxas: {kernel}: {text}", flush=True)

        def run_dkv(q, k, v, dout, lse, di, scale, call=dkv):
            dk = torch.empty_like(k)
            dv = torch.empty_like(v)
            call(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.shape[0], q.shape[2],
                 q.shape[1], k.shape[1], q.shape[3], *kernels._strides(q, k, v, dout, dk, dv),
                 scale)
            return dk, dv

        def run_dq(q, k, v, dout, lse, di, scale, call=dq):
            out = torch.empty_like(q)
            call(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), out.data_ptr(), q.shape[0], q.shape[2], q.shape[1], k.shape[1],
                 q.shape[3], *kernels._strides(q, k, v, dout, out), scale)
            return out
        runs[name] = (run_dkv, run_dq)

    gen = torch.Generator(device="cuda").manual_seed(5)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "ptxas": usage,
              "shapes": {}}
    for shape in args.shapes.split(","):
        b, h, sq, skv, d, gain = SHAPES[shape]
        scale = d ** -0.5
        q = (randn(b, sq, h, d) * gain).bfloat16()
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        out, lse = kernels.flash_lse(q, k, v, scale)
        dout = randn(b, sq, h, d).bfloat16()
        di = attention_di(out, dout)
        fns, errs, same, first = {}, {}, {}, None
        for name, (run_dkv, run_dq) in runs.items():
            dk, dv = run_dkv(q, k, v, dout, lse, di, scale)
            grads = {"dq": run_dq(q, k, v, dout, lse, di, scale), "dk": dk, "dv": dv}
            readings = attention_backward_error(grads, q, k, v, out, lse, dout, scale)
            if not readings["ok"]:
                raise AssertionError(f"{name} attention backward at {shape}: {readings}")
            errs[name] = max(readings[f"{g}_max_head_rel_err"] for g in ("dq", "dk", "dv"))
            first = first or grads
            same[name] = {g: torch.equal(x, first[g]) for g, x in grads.items()}
            fns[f"{name}_dkv_ms"] = (lambda f=run_dkv: f(q, k, v, dout, lse, di, scale))
            fns[f"{name}_dq_ms"] = (lambda f=run_dq: f(q, k, v, dout, lse, di, scale))
        del grads, first, dk, dv
        torch.cuda.empty_cache()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            sdpa_out = sdpa_flash(*leaves, scale)
        sdpa_dout = dout.transpose(1, 2)
        fns["sdpa_backward_ms"] = lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                                              retain_graph=True)
        t = in_turns(fns, dict.fromkeys(fns, ITERS))
        bounds = _backward_bound(b, h, sq, skv, d)
        prod = 2.0 * b * h * sq * skv * d
        row = {**t, "max_head_rel_err": errs, "bit_equal_to_parent": same,
               "shape": (b, h, sq, skv, d),
               **{f"{kern}_bound_ms": bounds[kern]["bound_ms"] for kern in KERNELS},
               "sfu_ms": bounds[KERNELS[0]]["sfu_ms"]}
        for name in trees:
            row[f"{name}_sum_ms"] = t[f"{name}_dkv_ms"] + t[f"{name}_dq_ms"]
        result["shapes"][shape] = row
        print(f"{shape} {(b, h, sq, skv, d)}: " + ", ".join(
            f"{name} dK/dV {t[f'{name}_dkv_ms']:.3f} ms ({4 * prod / t[f'{name}_dkv_ms'] / 1e9:.0f}"
            f" TFLOP/s), dQ {t[f'{name}_dq_ms']:.3f} ms ({3 * prod / t[f'{name}_dq_ms'] / 1e9:.0f}"
            f" TFLOP/s), both {row[f'{name}_sum_ms']:.3f} ms" for name in trees)
            + f"; flash SDPA backward {t['sdpa_backward_ms']:.3f} ms; bounds "
            f"{bounds[KERNELS[0]]['bound_ms']:.3f} / {bounds[KERNELS[1]]['bound_ms']:.3f} ms, SFU "
            f"{row['sfu_ms']:.3f} ms; max head rel err {errs}; bit-equal to the parent's "
            f"{same}", flush=True)
        del q, k, v, out, lse, dout, di, fns, leaves, sdpa_out
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
