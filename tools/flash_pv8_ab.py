#!/usr/bin/env python3
"""Time this checkout's K6 (flash_pv8) against another checkout's on one card.

    python3 tools/flash_pv8_ab.py --parent DIR [--tree NAME=DIR ...]

Builds ``csrc/flash_pv8.cu`` of this checkout ("change"), of the checkout at
DIR ("parent", e.g. the parent commit unpacked with ``git archive`` into a
directory ``.gitignore`` lists) and of any other trees named, with the flags
of ``ops/kernels.py``.  Each tree's kernel takes V^T in its own tree's layout
(``ops/attention_variants.py``: ``pv8_keys_last`` where the tree has it,
else ``keys_last``).  At each of K6's main-path shapes (the DiT's joint
attention, the Perceiver, the depth UNet's two kernel levels) every tree's
output is held to the plain version (``quantized_error``), and the kernels
are timed with CUDA events in turns (the trees in order, then in reverse)
beside flash SDPA, the exact attention K6 approximates (a yardstick).
Prints the card's name and power limit, a line per shape, and one JSON line.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

ITERS = 5
# (B, H, Sq, Skv, D, q gain): the DiT's joint self-attention, the
# Perceiver's cross-attention (no QK-norm: peaked rows), the depth UNet's
# 9,216- and 2,304-token levels at 49 frames
SHAPES = {
    "dit": (2, 48, 13330, 13330, 64, 1.0),
    "perceiver": (2, 16, 13104, 3024, 128, 4.0),
    "depth_9216": (49, 5, 9216, 9216, 64, 4.0),
    "depth_2304": (49, 10, 2304, 2304, 64, 4.0),
}


def _layout(root: Path, name: str):
    """The V^T layout function of the tree at ``root``."""
    path = root / "trajectorycrafter_tpu_torch" / "ops" / "attention_variants.py"
    spec = importlib.util.spec_from_file_location(f"_pv8_ab_variants_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "pv8_keys_last", None) or mod.keys_last


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

    from chip_smoke import attention_bound, in_turns
    from int8_gemm_ab import _launcher
    from trajectorycrafter_tpu_torch.bench_attention import sdpa_flash
    from trajectorycrafter_tpu_torch.ops import attention_variants as av
    from trajectorycrafter_tpu_torch.ops import kernels
    from trajectorycrafter_tpu_torch.ops.attention import plain_refs, quantized_error

    if not torch.cuda.is_available():
        raise SystemExit("flash_pv8_ab: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.strip()
    import chip_smoke
    chip_smoke.DEVICE["sm_clock_hz"] = float(clock.splitlines()[0]) * 1e6

    trees = {"parent": args.parent.resolve(), "change": REPO}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    runs = {}
    for name, root in trees.items():
        call, notes = _launcher(root / "trajectorycrafter_tpu_torch" / "csrc", "flash_pv8",
                                kernels._PV8_ARGTYPES)
        layout = _layout(root, name)
        for note in notes:
            print(f"[{name}] ptxas: {note}", flush=True)

        def run(q, k, v8t, vs, scale_log2, block_k, call=call):
            b, sq, h, d = q.shape
            out = torch.empty_like(q)
            call(q.data_ptr(), k.data_ptr(), v8t.data_ptr(), vs.data_ptr(), out.data_ptr(), b, h,
                 sq, k.shape[1], d, block_k, *q.stride()[:3], *k.stride()[:3], v8t.shape[2],
                 *out.stride()[:3], scale_log2)
            return out
        runs[name] = (run, layout)

    gen = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "shapes": {}}
    for shape in args.shapes.split(","):
        b, h, sq, skv, d, gain = SHAPES[shape]
        scale, block_k = d ** -0.5, av.pv8_block_k(sq)
        q = (randn(b, sq, h, d) * gain).bfloat16()
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        v8, vs = av.quantize_per_head(v)
        vs = vs.reshape(-1)
        refs = plain_refs(lambda x: av.pv8_reference(q, k, x, scale, block_k), v)
        fns, rows = {}, {}
        for name, (run, layout) in runs.items():
            v8t = layout(v8)
            readings = quantized_error(run(q, k, v8t, vs, scale * av.LOG2E, block_k), *refs)
            if not readings["ok"]:
                raise AssertionError(f"{name} flash_pv8 at {shape}: {readings}")
            rows[name] = readings["max_row_rel_err"]
            fns[f"{name}_ms"] = (lambda run=run, v8t=v8t:
                                 run(q, k, v8t, vs, scale * av.LOG2E, block_k))
        del refs
        torch.cuda.empty_cache()
        fns["sdpa_ms"] = lambda: sdpa_flash(q, k, v, scale)
        t = in_turns(fns, dict.fromkeys(fns, ITERS))
        flop = 4.0 * b * h * sq * skv * d
        row = {**t, "max_row_rel_err": rows, "shape": (b, h, sq, skv, d), "block_k": block_k,
               **attention_bound(b, h, sq, skv, d, pv_int8=True)}
        result["shapes"][shape] = row
        print(f"{shape} {(b, h, sq, skv, d)}, key blocks of {block_k}: " + ", ".join(
            f"{key[:-3]} {ms:.3f} ms ({flop / ms / 1e9:.0f} TFLOP/s)" for key, ms in t.items())
            + f"; bound {row['bound_ms']:.3f} ms ({row['bound_by']}), SFU {row['sfu_ms']:.3f} ms;"
            f" max row rel err {rows}", flush=True)
        del q, k, v, v8, fns
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
