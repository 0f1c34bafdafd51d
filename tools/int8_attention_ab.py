#!/usr/bin/env python3
"""Time this checkout's K7 (int8_flash_attention) against another checkout's on one card.

    python3 tools/int8_attention_ab.py --parent DIR [--tree NAME=DIR ...]

Builds ``csrc/int8_flash_attention.cu`` of this checkout ("change"), of the
checkout at DIR ("parent", e.g. the parent commit unpacked with ``git
archive`` into a directory ``.gitignore`` lists) and of any other trees
named, with the flags of ``ops/kernels.py``.  Each tree's kernel takes V^T
in its own tree's layout (``ops/attention_variants.py``: ``keys_last``
where the tree still has it, the 64-key layout of a K7 before the PV-int8
loop, else ``pv8_keys_last``).  At the DiT's joint-attention shape and a
head-dim-128 self-attention shape every tree's output is held to the plain
version (``quantized_error``), and the kernels are timed with CUDA events
in turns (the trees in order, then in reverse) beside flash SDPA, the exact
attention K7 approximates (a yardstick).  Prints the card's name and power
limit, a line per shape, and one JSON line.
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
# (B, H, Sq, Skv, D): the DiT's joint self-attention, and chip_smoke.py's
# head-dim-128 self-attention
SHAPES = {
    "dit": (2, 48, 13330, 13330, 64),
    "d128": (1, 16, 4096, 4096, 128),
}


def _module(root: Path, name: str, tag: str):
    """``trajectorycrafter_tpu_torch/ops/<name>.py`` of the tree at ``root``."""
    path = root / "trajectorycrafter_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_int8_ab_{name}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(root: Path, tag: str):
    """The V^T layout function of K7 in the tree at ``root``, reading that
    tree's own key tile (its ``ops/kernels.py``)."""
    variants = _module(root, "attention_variants", tag)
    variants.kernels = _module(root, "kernels", tag)
    return getattr(variants, "keys_last", None) or variants.pv8_keys_last


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
        raise SystemExit("int8_attention_ab: needs a CUDA card")
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
        call, notes = _launcher(root / "trajectorycrafter_tpu_torch" / "csrc",
                                "int8_flash_attention", kernels._INT8_ATTN_ARGTYPES)
        layout = _layout(root, name)
        for note in notes:
            print(f"[{name}] ptxas: {note}", flush=True)

        def run(q8, k8, v8t, logit, v127, block_k, call=call):
            b, sq, h, d = q8.shape
            out = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q8.device)
            call(q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(), logit.data_ptr(), v127.data_ptr(),
                 out.data_ptr(), b, h, sq, k8.shape[1], d, block_k, *q8.stride()[:3],
                 *k8.stride()[:3], v8t.shape[2], *out.stride()[:3])
            return out
        runs[name] = (run, layout)

    gen = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "shapes": {}}
    for shape in args.shapes.split(","):
        b, h, sq, skv, d = SHAPES[shape]
        scale, block_k = d ** -0.5, av.int8_block_k(sq)
        q = randn(b, sq, h, d).bfloat16()
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        q8, k8, v8, logit, v127 = av.int8_operands(q, k, v, scale)
        refs = plain_refs(lambda x: av.int8_attention_reference(q, k, x, scale, block_k), v)
        fns, rows = {}, {}
        for name, (run, layout) in runs.items():
            v8t = layout(v8)
            readings = quantized_error(run(q8, k8, v8t, logit, v127, block_k), *refs)
            if not readings["ok"]:
                raise AssertionError(f"{name} int8_flash_attention at {shape}: {readings}")
            rows[name] = readings["max_row_rel_err"]
            fns[f"{name}_ms"] = (lambda run=run, v8t=v8t:
                                 run(q8, k8, v8t, logit, v127, block_k))
        del refs
        torch.cuda.empty_cache()
        fns["sdpa_ms"] = lambda: sdpa_flash(q, k, v, scale)
        t = in_turns(fns, dict.fromkeys(fns, ITERS))
        flop = 4.0 * b * h * sq * skv * d
        row = {**t, "max_row_rel_err": rows, "shape": (b, h, sq, skv, d), "block_k": block_k,
               **attention_bound(b, h, sq, skv, d, pv_int8=True, qk_int8=True, in_bytes=1)}
        result["shapes"][shape] = row
        print(f"{shape} {(b, h, sq, skv, d)}, key blocks of {block_k}: " + ", ".join(
            f"{key[:-3]} {ms:.3f} ms ({flop / ms / 1e9:.0f} TOP/s)" for key, ms in t.items())
            + f"; bound {row['bound_ms']:.3f} ms ({row['bound_by']}), SFU {row['sfu_ms']:.3f} ms;"
            f" max row rel err {rows}", flush=True)
        del q, k, v, q8, k8, v8, fns
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
