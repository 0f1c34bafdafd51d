#!/usr/bin/env python3
"""Time this checkout's int8 GEMM kernels against another checkout's on one card.

    python3 tools/int8_gemm_ab.py --parent DIR [--tree NAME=DIR ...]

Builds ``csrc/int8_gemm.cu`` (K2b), ``csrc/int8_gemm_gscale.cu`` (K3b) and
``csrc/int8_gemm_gelu_quant.cu`` (K3a) of this checkout ("change"), of the
checkout at DIR ("parent", e.g. the parent commit unpacked with ``git
archive`` into a directory ``.gitignore`` lists) and of any other trees
named (variants under trial), with the flags of ``ops/kernels.py``.  Each
tree's K2b runs at every shape of ``chip_smoke.INT8_SHAPES``, its K3a at the
fused feed-forward's first GEMM (at each of ``--groups``, beside this
tree's K2b on the same inputs) and its K3b at the second, on the same
inputs; each output is held to the plain version (``gemm_error``, 0 bf16
ulps expected; K3a by ``gelu_quant_error``), and the kernels are timed with
CUDA events in turns (the trees in order, then in reverse) beside
``torch._int_mm`` (the int32 product only) and the bf16 ``F.linear`` the
layer replaces.  Prints the card's name and power limit, a line per shape,
and one JSON line.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ITERS = 10


def _launcher(csrc: Path, name: str, argtypes: tuple, source: str = None):
    """``<name>_fwd`` of ``csrc/<source or name>.cu``, built with the port's
    flags, as a function of the arguments between the device index and the
    stream."""
    import torch

    from trajectorycrafter_tpu_torch.ops import kernels

    source = source or name
    info = kernels.build_library(f"{source}.cu", csrc)
    lib = ctypes.CDLL(str(info["path"]))
    fwd = getattr(lib, f"{name}_fwd")
    fwd.argtypes = list(argtypes)
    fwd.restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]

    def call(*args):
        status = fwd(torch.cuda.current_device(), *args, torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{csrc}/{name}: {err(status).decode()}")

    notes = [line.strip() for line in info["log"].splitlines()
             if "registers" in line or "spill" in line or "C75" in line]
    return call, notes


def _gemm(call):
    import torch

    def run(xq, wq, xs, ws, bias):
        out = torch.empty((xq.shape[0], wq.shape[0]), dtype=torch.bfloat16, device=xq.device)
        call(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(), xq.shape[0],
             wq.shape[0], xq.shape[1], xq.stride(0), wq.stride(0))
        return out
    return run


def _gscale(call):
    import torch

    def run(hq, wq, hs, ws, bias, group):
        out = torch.empty((hq.shape[0], wq.shape[0]), dtype=torch.bfloat16, device=hq.device)
        call(hq.data_ptr(), wq.data_ptr(), hs.data_ptr(), ws.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(), hq.shape[0],
             wq.shape[0], hq.shape[1], hq.stride(0), wq.stride(0), group)
        return out
    return run


def _gelu_quant(call):
    import torch

    def run(xq, wq, xs, ws, bias, group):
        m, n = xq.shape[0], wq.shape[0]
        hq = torch.empty((m, n), dtype=torch.int8, device=xq.device)
        hs = torch.empty((m, n // group), dtype=torch.float32, device=xq.device)
        call(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
             None if bias is None else bias.data_ptr(), hq.data_ptr(), hs.data_ptr(), m, n,
             xq.shape[1], xq.stride(0), wq.stride(0), group)
        return hq, hs
    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="the checkout to compare with (its root directory)")
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: a further checkout to time beside the two")
    parser.add_argument("--groups", default="1024",
                        help="comma-separated column groups to time K3a at (a multiple of "
                             "128 up to 1,024 that divides 12,288)")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    from chip_smoke import INT8_SHAPES, _int8_bounds, in_turns
    from trajectorycrafter_tpu_torch.ops import int8_matmul as im
    from trajectorycrafter_tpu_torch.ops import kernels
    from trajectorycrafter_tpu_torch.ops.int8 import quantize_dense

    if not torch.cuda.is_available():
        raise SystemExit("int8_gemm_ab: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"parent": args.parent.resolve(), "change": REPO}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    gemms, gscales, gelu_quants = {}, {}, {}
    for name, root in trees.items():
        csrc = root / "trajectorycrafter_tpu_torch" / "csrc"
        call, notes = _launcher(csrc, "int8_gemm", kernels._GEMM_ARGTYPES)
        gemms[name] = _gemm(call)
        call, notes_g = _launcher(csrc, "int8_gemm_gscale", kernels._GSCALE_ARGTYPES)
        gscales[name] = _gscale(call)
        call, notes_q = _launcher(csrc, "int8_gemm_gelu_quant", kernels._GELU_QUANT_ARGTYPES)
        gelu_quants[name] = _gelu_quant(call)
        for note in notes + notes_g + notes_q:
            print(f"[{name}] ptxas: {note}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(2)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "shapes": {}}
    for shape, (m, k, n, has_bias) in INT8_SHAPES.items():
        x = (randn(m, k) * 2.0).bfloat16()
        w = (randn(n, k) * k ** -0.5).bfloat16()
        wq, ws = quantize_dense(w)
        b = (randn(n) * 0.1).bfloat16() if has_bias else None
        xq, xs = im.quantize_rows_reference(x)
        bias = None if b is None else b.float()
        ref = im.int8_matmul_reference(xq, wq, xs, ws, b)
        ulps = {}
        for name, gemm in gemms.items():
            readings = im.gemm_error(gemm(xq, wq, xs, ws, bias), ref)
            if not readings["ok"]:
                raise AssertionError(f"{name} int8_gemm at {shape}: {readings}")
            ulps[name] = readings["max_ulps"]
        del ref
        fns = {f"{name}_ms": (lambda g=gemm: g(xq, wq, xs, ws, bias)) for name, gemm in gemms.items()}
        fns["int_mm_ms"] = lambda: torch._int_mm(xq, wq.t())
        fns["bf16_linear_ms"] = lambda: F.linear(x, w, b)
        t = in_turns(fns, dict.fromkeys(fns, ITERS))
        ops = 2.0 * m * k * n
        row = {**t, "max_ulps": ulps, "shape": (m, k, n),
               **_int8_bounds(shape, im.FF_GROUP)["int8_gemm"]}
        result["shapes"][shape] = row
        print(f"{shape} (M {m}, K {k}, N {n}): " + ", ".join(
            f"{key[:-3]} {ms:.3f} ms ({ops / ms / 1e9:.0f} TOP/s)" for key, ms in t.items())
            + f"; bound {row['bound_ms']:.3f} ms ({row['bound_by']}); max ulps {ulps}", flush=True)
        del x, w, wq, ws, b, bias, xq, xs, fns
        torch.cuda.empty_cache()

    # K3a at the fused feed-forward's first GEMM, at each group asked for,
    # beside this tree's K2b on the same inputs (the same products with a
    # bf16 epilogue: the difference is what K3a's epilogue leaves unhidden)
    m, k, n, _ = INT8_SHAPES["dit_ff1"]
    x = (randn(m, k) * 2.0).bfloat16()
    wq, ws = quantize_dense(randn(n, k) * k ** -0.5)
    bias = randn(n) * 0.1
    xq, xs = im.quantize_rows_reference(x)
    ops = 2.0 * m * k * n
    for group in (int(g) for g in args.groups.split(",")):
        ref = im.int8_matmul_gelu_quant_reference(xq, wq, xs, ws, bias, group)
        errs = {}
        for name, gelu_quant in gelu_quants.items():
            readings = im.gelu_quant_error(*gelu_quant(xq, wq, xs, ws, bias, group), *ref)
            if not readings["ok"]:
                raise AssertionError(f"{name} int8_gemm_gelu_quant, group {group}: {readings}")
            errs[name] = {key: readings[key] for key in ("max_abs_err", "code_flip_share")}
        del ref
        fns = {f"{name}_ms": (lambda g=g: g(xq, wq, xs, ws, bias, group))
               for name, g in gelu_quants.items()}
        fns["change_int8_gemm_ms"] = lambda: gemms["change"](xq, wq, xs, ws, bias)
        t = in_turns(fns, dict.fromkeys(fns, ITERS))
        key = "gelu_quant_dit_ff1" + ("" if group == im.FF_GROUP else f"_group{group}")
        result[key] = {**t, "max_abs_err": errs, "group": group,
                       **_int8_bounds("dit_ff1", group)["int8_gemm_gelu_quant"]}
        print(f"int8_gemm_gelu_quant dit_ff1, group {group}: " + ", ".join(
            f"{key[:-3]} {ms:.3f} ms ({ops / ms / 1e9:.0f} TOP/s)" for key, ms in t.items())
            + f"; against the plain version {errs}", flush=True)
        del fns
    del x, xq, xs, wq, ws, bias
    torch.cuda.empty_cache()

    # K3b at the fused feed-forward's second GEMM: codes and group scales as
    # the gelu-quant GEMM writes them (random here)
    m, k, n, _ = INT8_SHAPES["dit_ff2"]
    group = im.FF_GROUP
    hq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    hs = torch.rand((m, k // group), generator=gen, device="cuda") * 0.01 + 1e-4
    wq, ws = quantize_dense(randn(n, k) * k ** -0.5)
    bias = randn(n) * 0.1
    ref = im.int8_matmul_gscale_reference(hq, wq, hs, ws, bias, group)
    ulps = {}
    for name, gscale in gscales.items():
        readings = im.gemm_error(gscale(hq, wq, hs, ws, bias, group), ref)
        if not readings["ok"]:
            raise AssertionError(f"{name} int8_gemm_gscale: {readings}")
        ulps[name] = readings["max_ulps"]
    del ref
    fns = {f"{name}_ms": (lambda g=g: g(hq, wq, hs, ws, bias, group)) for name, g in gscales.items()}
    t = in_turns(fns, dict.fromkeys(fns, ITERS))
    ops = 2.0 * m * k * n
    result["gscale_dit_ff2"] = {**t, "max_ulps": ulps, "group": group,
                                **_int8_bounds("dit_ff2", group)["int8_gemm_gscale"]}
    print(f"int8_gemm_gscale dit_ff2, group {group}: " + ", ".join(
        f"{key[:-3]} {ms:.3f} ms ({ops / ms / 1e9:.0f} TOP/s)" for key, ms in t.items())
        + f"; max ulps {ulps}", flush=True)

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
