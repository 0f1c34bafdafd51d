"""Attention kernel microbenchmark of the PyTorch port, at the JAX bench's shapes.

    python -m trajectorycrafter_tpu_torch.bench_attention           # on the CUDA card
    python -m trajectorycrafter_tpu_torch.bench_attention --small   # plain versions, CPU

Counterpart of bench_attention.py.  Shapes: the DiT's joint attention of the
JAX bench, 2 x 48 heads x (226 text + 13 x 36 x 64 video = 30,178 tokens,
zero-padded to 30,720) x 64, with ``kv_valid`` marking the real keys; and
the depth UNet's largest spatial attention, 49 frames x 5 heads x 9,216 x
64.  Timed with CUDA events, each kernel for a few launches after one:

  flash_stock         the running-max kernel (K1/K4, csrc/flash_attention.cu)
                      on the padded tensors, the JAX bench's ``flash_stock``
  flash_lse           K5 (the same, with its logsumexp)
  flash_exp2_512x1024 K1b with ``kv_valid`` (its answer does not depend on the
                      JAX block sizes of the name)
  dispatch_flash      ``multi_head_attention(impl="auto")`` (K1)
  dispatch_flash_pv8  ``multi_head_attention(impl="flash_pv8")`` (K6, V's
                      quantization pass included)
  int8_flash          K7 through ``int8_attention`` (its quantization included)
  sdpa_flash          ``F.scaled_dot_product_attention`` on the flash backend,
                      a yardstick the port never calls
  depth_flash_stock, depth_flash_max   K4 and K4b at the depth shape

Before timing, each kernel is held to its plain version at a small ragged
shape (ops/attention.py's bounds).  Prints one JSON line with the JAX
script's keys: ``metric``, ``value`` (the fastest DiT-shaped entry),
``unit``, ``vs_baseline`` (``flash_stock`` over the fastest) and
``<name>_ms``.  ``--small`` runs the plain versions on the CPU at 1 x 4 x
2,000 (padded to 2,048) x 64 and times them with the host clock; it checks
no kernel (there is none on the CPU).  Without ``--small`` it needs a card.
"""

from __future__ import annotations

import json
import sys
import time

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from trajectorycrafter_tpu_torch.ops import attention_variants as av
from trajectorycrafter_tpu_torch.ops import kernels
from trajectorycrafter_tpu_torch.ops.attention import (
    attention_error,
    kernel_error,
    lse_error,
    multi_head_attention,
    output_error,
    plain_refs,
    quantized_error,
)

DIT = (2, 48, 226 + 13 * 36 * 64, 64)  # (B, H, real tokens, D)
DEPTH = (49, 5, 9216, 64)
PAD_BLOCK = 1024


def make_qkv(b, h, s_real, d, device, block=PAD_BLOCK, seed=0):
    """(B, S, H, D) bf16 q, k, v zero-padded past ``s_real`` to a multiple of
    ``block``, and the (S,) validity mask, from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = s_real + (-s_real) % block
    valid = (torch.arange(s, device=device) < s_real).float()
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    make = lambda: (torch.randn((b, s, h, d), generator=gen, device=device)
                    * valid[None, :, None, None]).to(dtype)
    return make(), make(), make(), valid


def check_kernels(scale: float) -> None:
    """Each kernel against its plain version at 1 x 2 x 1,000 (ragged) x 64."""
    q, k, v, valid = make_qkv(1, 2, 1000, 64, "cuda", block=1, seed=1)
    block, block_int8 = av.pv8_block_k(q.shape[1]), av.int8_block_k(q.shape[1])
    checks = {
        "flash_stock": attention_error(kernels.flash_attention(q, k, v, scale), q, k, v, scale),
        "flash_max": kernel_error(kernels.flash_maxpass, kernels.flash_maxpass(q, k, v, scale),
                                  q, k, v, scale),
        "flash_exp2": output_error(
            kernels.flash_exp2(q, k, v, scale),
            *plain_refs(lambda x: av.exp2_attention_reference(q, k, x, scale), v)),
        "dispatch_flash_pv8": quantized_error(
            multi_head_attention(q, k, v, scale, "flash_pv8").unflatten(-1, (2, 64)),
            *plain_refs(lambda x: av.pv8_reference(q, k, x, scale, block), v)),
        "int8_flash": quantized_error(
            av.int8_attention(q, k, v, scale, block_int8),
            *plain_refs(lambda x: av.int8_attention_reference(q, k, x, scale, block_int8), v)),
    }
    out, lse = kernels.flash_lse(q, k, v, scale)
    checks["flash_lse"] = attention_error(out, q, k, v, scale)
    checks["flash_lse_logsumexp"] = lse_error(lse, q, k, scale)
    torch.cuda.synchronize()
    for name, readings in checks.items():
        print(f"# {name} vs its plain version (1 x 2 x 1000 x 64): "
              + ", ".join(f"{key} {val:.3e}" for key, val in readings.items() if key != "ok"),
              file=sys.stderr)
        assert readings["ok"], f"{name} disagrees with its plain version: {readings}"


def sdpa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The library yardstick: ``F.scaled_dot_product_attention`` on its flash
    backend over (B, H, S, D) views of (B, S, H, D) tensors.  Timed beside
    the kernels; the port never calls it."""
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), scale=scale)


def time_cuda(fn, iters: int = 5) -> float:
    """Seconds per call: CUDA events around ``iters`` calls after one."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def time_host(fn, iters: int = 2) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    small = "--small" in argv
    if not small and not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA card (pass --small for the plain "
                         "versions on the CPU)")
    b, h, s_real, d = DIT
    if small:
        b, h, s_real = 1, 4, 2000
    scale = d ** -0.5
    device = "cpu" if small else "cuda"
    if not small:
        check_kernels(scale)
    q, k, v, valid = make_qkv(b, h, s_real, d, device)
    s = q.shape[1]
    block_k = av.int8_block_k(s)

    fns = {
        "flash_stock": lambda: multi_head_attention(q, k, v, scale, "flash_stock"),
        "flash_lse": lambda: av.lse_attention(q, k, v, scale),
        "flash_exp2_512x1024": lambda: av.exp2_attention(q, k, v, scale, valid),
        "dispatch_flash": lambda: multi_head_attention(q, k, v, scale, "auto"),
        "dispatch_flash_pv8": lambda: multi_head_attention(q, k, v, scale, "flash_pv8"),
        "int8_flash": lambda: av.int8_attention(q, k, v, scale, block_k),
    }
    if not small:
        fns["sdpa_flash"] = lambda: sdpa_flash(q, k, v, scale)
    timer = time_host if small else time_cuda
    results = {}
    for name, fn in fns.items():
        results[name] = timer(fn)
        print(f"# {name}: {results[name] * 1e3:.3f} ms", file=sys.stderr)
    del q, k, v

    if not small:
        qd, kd, vd, _ = make_qkv(*DEPTH, device, seed=2)
        for name, impl in (("depth_flash_stock", "flash_stock"), ("depth_flash_max", "flash_max")):
            results[name] = timer(lambda: multi_head_attention(qd, kd, vd, scale, impl))
            print(f"# {name}: {results[name] * 1e3:.3f} ms", file=sys.stderr)
        del qd, kd, vd

    dit_shaped = {n: t for n, t in results.items()
                  if not n.startswith("depth_") and n != "sdpa_flash"}
    best = min(dit_shaped.values())
    line = {
        "metric": "attention_layer_call_ms",
        "value": best * 1e3,
        "unit": f"ms/call ({b}x{h}x{s}x{d} bf16)" if not small
        else f"ms/call ({b}x{h}x{s}x{d} fp32, plain versions on the CPU)",
        "vs_baseline": results["flash_stock"] / best,
        "device": torch.cuda.get_device_name(0) if not small else "cpu",
        **{f"{n}_ms": t * 1e3 for n, t in results.items()},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
