"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel lives in ``trajectorycrafter_tpu_torch/csrc`` as CUDA C++ with a
plain C entry point.  At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/trajectorycrafter_tpu_torch/``
(beside the package), keyed by a hash of its source and flags, and loaded
with ``ctypes``.  Nothing is built or loaded when this module is imported.

The wrappers take CUDA tensors only: they check device, dtype, shape and
strides, launch on ``torch.cuda.current_stream()``, and raise on a nonzero
launch status.  They never fall back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_ROOT = _PACKAGE_DIR.parent / "build" / "trajectorycrafter_tpu_torch"
# sm_90a, not sm_90: the attention kernels use `wgmma` and `setmaxnreg`.  No
# -lcuda: their TMA tensor maps are encoded through the CUDA driver entry point
# the runtime hands out (cudaGetDriverEntryPoint).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
FLASH_HEAD_DIMS = (64, 128)
# keys per K/V tile of the bf16 attention kernels: flash_attention,
# flash_lse, flash_exp2 and flash_maxpass (csrc/hopper_attention.cuh kBlockN)
ATTENTION_KEY_TILE = 128
# keys per K / V^T tile of the PV-int8 loop (csrc/hopper_attention.cuh
# kBlockN), which runs flash_pv8 and int8_flash_attention: their key blocks
# and their V^T rows are multiples of it
PV8_KEY_TILE = 128
# the attention backward's tiles (csrc/flash_attention_bwd.cu): a dK/dV block
# owns 128 keys and streams 64-query tiles (kQueryTile); a dQ block owns 128
# queries and streams 128-key tiles (the forward's kBlockN)
BWD_DKV_QUERY_TILE = 64
BWD_DQ_KEY_TILE = 128


def _nvcc() -> str:
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use")
    return found


def build_library(source_name: str, csrc: Path = CSRC_DIR) -> dict:
    """Compile ``csrc/<source_name>`` unless a build of the same source and
    flags exists (``csrc``: this package's sources, or another checkout's, as
    tools/int8_gemm_ab.py builds them).  Returns {"path", "seconds" (0.0
    when cached), "log"}."""
    source = csrc / source_name
    # the key covers the shared headers too: a source includes them
    headers = b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / (Path(source_name).stem + ".so")
    log_path = out_dir / (Path(source_name).stem + ".log")
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return {"path": lib_path, "seconds": 0.0, "log": log}
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_path = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp_path, lib_path)  # atomic: concurrent builders agree
    return {"path": lib_path, "seconds": seconds, "log": log}


_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """Build and load ``csrc/<name>.cu``; its ``<name>_error_string`` names a
    cudaError_t."""
    lib = ctypes.CDLL(str(build_library(f"{name}.cu")["path"]))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _entry(source: str, entry: str, argtypes: tuple):
    """The entry point ``<entry>_fwd`` of ``csrc/<source>.cu``: it takes
    ``argtypes`` (ctypes types; the device index first and the stream last)
    and returns a cudaError_t."""
    fwd = getattr(_library(source), f"{entry}_fwd")
    fwd.argtypes = list(argtypes)
    fwd.restype = ctypes.c_int
    return fwd


def _call(name: str, argtypes: tuple, device: torch.device, *args, source: str = None) -> None:
    """Launch ``<name>_fwd(device index, *args, current stream)`` of
    ``csrc/<source or name>.cu``; raise on a nonzero launch status."""
    source = source or name
    fwd = _entry(source, name, argtypes)
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fwd(index, *args, stream)
    if status != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(_library(source), f"{source}_error_string")(status).decode())


_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.int8: "int8"}


def _check_bshd(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, S, H, D), got shape {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must be dense in the head dim, strides {x.stride()}")
    # the kernels move rows as 16-byte vectors, or by TMA, which takes
    # 16-byte aligned base addresses and strides
    if any(s * x.element_size() % 16 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs 16-byte aligned rows (strides {x.stride()} and the data "
            "pointer must be multiples of 16 bytes)")


def refuse_grad(kernel: str, *xs) -> None:
    """Raise where autograd would need a gradient through ``kernel``: the
    forward kernels write into fresh tensors with no ``grad_fn``, so a
    gradient through them would be lost without a sound.  Only
    ``FlashAttentionFunction`` (ops/attention.py, ``impl="flash_stock"``)
    has backward kernels."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs):
        raise RuntimeError(
            f"{kernel} has no backward kernel and would cut the gradient: run it under "
            "torch.no_grad(), or take multi_head_attention(impl='flash_stock'), the "
            "differentiable route (ops/attention.py FlashAttentionFunction)")


def _check_attention(kernel: str, q: torch.Tensor, k: torch.Tensor, v,
                     dtype=torch.bfloat16) -> tuple:
    """Check q (B, Sq, H, D) and k (and v unless None) (B, Skv, H, D): CUDA
    tensors of ``dtype`` on one device with aligned rows, D in
    ``FLASH_HEAD_DIMS``, none needing a gradient (``refuse_grad``); returns
    (B, Sq, Skv, H, D)."""
    refuse_grad(kernel, q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x is None:
            continue
        if not x.is_cuda:
            raise ValueError(f"{kernel} takes CUDA tensors; {name} is on {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{kernel} takes {_DTYPE_NAMES[dtype]}; {name} is {x.dtype}")
        _check_bshd(name, x)
    if q.device != k.device or (v is not None and v.device != q.device):
        raise ValueError("q, k and v must be on one device")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or (v is not None and v.shape != k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {None if v is None else tuple(v.shape)}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
    if sq == 0 or skv == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes: B*H={b * h}, Sq={sq}, Skv={skv}")
    return b, sq, skv, h, d


def _strides(*xs) -> list:
    """The (batch, sequence, head) strides of each (B, S, H, D) tensor."""
    return [s for x in xs for s in x.stride()[:3]]


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            extra_ptrs=(), tail=(), tail_types=(), source: str = "flash_attention"
            ) -> torch.Tensor:
    """Check q, k, v (B, S, H, D) as the bf16 attention kernels take them,
    launch ``<kernel>_fwd(device, q, k, v, out, *extra_ptrs, B, H, Sq, Skv, D,
    strides of q, k, v and out, scale, *tail, stream)`` of ``csrc/<source>.cu``
    into a new output and raise on a nonzero launch status."""
    b, sq, skv, h, d = _check_attention(kernel, q, k, v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    argtypes = (_INT, *[_PTR] * (4 + len(extra_ptrs)), *[_INT] * 5, *[_LONG] * 12,
                ctypes.c_float, *tail_types, _PTR)
    _call(kernel, argtypes, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          *extra_ptrs, b, h, sq, skv, d, *_strides(q, k, v, out), float(scale), *tail,
          source=source)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Non-causal softmax(q k^T * scale) v on the card with an online running
    max (csrc/flash_attention.cu), (B, S, H, D) in and out.

    q: (B, Sq, H, D), k and v: (B, Skv, H, D); bf16 CUDA tensors on one
    device, D in {64, 128}.  Counts each launch in ``flash_attention.launches``.
    """
    out = _launch("flash_attention", q, k, v, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_maxpass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The same attention in two passes (csrc/flash_maxpass.cu): the exact
    row max of the scaled scores first, then exp2 attention against it, both
    in one launch.  Takes what ``flash_attention`` takes.  Counts each call
    in ``flash_maxpass.launches``."""
    out = _launch("flash_maxpass", q, k, v, scale, source="flash_maxpass")
    flash_maxpass.launches += 1
    return out


flash_maxpass.launches = 0


def flash_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """``flash_attention``'s attention, which also returns the natural-log
    logsumexp of each query row's scaled scores (csrc/flash_attention.cu,
    entry point flash_lse): -> (out (B, Sq, H, D) bf16, lse (B, H, Sq) fp32).
    Takes what ``flash_attention`` takes.  Counts each launch in
    ``flash_lse.launches``."""
    b, sq, _, h, _ = _check_attention("flash_lse", q, k, v)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    out = _launch("flash_lse", q, k, v, scale, extra_ptrs=(lse.data_ptr(),))
    flash_lse.launches += 1
    return out, lse


flash_lse.launches = 0


def flash_exp2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               kv_valid: Optional[torch.Tensor] = None, bias: float = 0.0,
               clamp: bool = True) -> torch.Tensor:
    """exp2 attention with a fixed bias and no running max (csrc/
    flash_attention.cu, entry point flash_exp2): q rounded to bf16 after the
    scale * log2(e), p = bf16(exp2(min(q.k - bf16(bias), 110))) (no cap
    unless ``clamp``), normalised by the sum of the same p over the keys
    ``kv_valid`` marks (a (Skv,) tensor, nonzero = a real key; None = all).
    Takes what ``flash_attention`` takes.  Counts each launch in
    ``flash_exp2.launches``."""
    _, _, skv, _, _ = _check_attention("flash_exp2", q, k, v)
    mask = None
    if kv_valid is not None:
        if tuple(kv_valid.shape) != (skv,) or kv_valid.device != q.device:
            raise ValueError(f"flash_exp2: kv_valid must be ({skv},) on {q.device}, got "
                             f"{tuple(kv_valid.shape)} on {kv_valid.device}")
        mask = (kv_valid != 0).to(torch.uint8).contiguous()
    bias_bf16 = float(torch.tensor(bias, dtype=torch.bfloat16))  # the bias lane is bf16
    out = _launch("flash_exp2", q, k, v, scale, extra_ptrs=(_ptr(mask),),
                  tail=(bias_bf16, int(bool(clamp))), tail_types=(ctypes.c_float, _INT))
    flash_exp2.launches += 1
    return out


flash_exp2.launches = 0


# ----------------------------------------------------------------------------
# the attention backward (csrc/flash_attention_bwd.cu)
# ----------------------------------------------------------------------------

_BWD_DKV_ARGTYPES = (_INT, *[_PTR] * 8, *[_INT] * 5, *[_LONG] * 18, ctypes.c_float, _PTR)
_BWD_DQ_ARGTYPES = (_INT, *[_PTR] * 7, *[_INT] * 5, *[_LONG] * 15, ctypes.c_float, _PTR)


def _check_backward(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dout: torch.Tensor, lse: torch.Tensor, di: torch.Tensor) -> tuple:
    """Check what the backward kernels take: q, k, v as the forward kernels
    take them, dout (B, Sq, H, D) bf16 like q, lse and di (B, H, Sq) fp32
    contiguous on q's device; returns (B, Sq, Skv, H, D)."""
    b, sq, skv, h, d = _check_attention(kernel, q, k, v)
    _check_tensor(kernel, "dout", dout, torch.bfloat16, (b, sq, h, d), q.device)
    _check_bshd("dout", dout)
    for name, x in (("lse", lse), ("di", di)):
        _check_tensor(kernel, name, x, torch.float32, (b, h, sq), q.device)
        _check_dense(kernel, name, x)
    return b, sq, skv, h, d


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor, di: torch.Tensor,
                            scale: float):
    """dK and dV of ``flash_attention``'s attention on the card (csrc/
    flash_attention_bwd.cu, entry point flash_attention_bwd_dkv): with p =
    exp(q k^T * scale - lse) and ds = p (dout v^T - di), -> (dk = scale ds^T
    q, dv = p^T dout), each (B, Skv, H, D) bf16.  q, k, v as
    ``flash_attention`` takes them; dout (B, Sq, H, D) bf16; lse (B, H, Sq)
    fp32, the natural-log logsumexp ``flash_lse`` returns; di (B, H, Sq) fp32,
    sum(out * dout) over the head dim.  Counts each launch in
    ``flash_attention_bwd_dkv.launches``."""
    kernel = "flash_attention_bwd_dkv"
    b, _, skv, h, d = _check_backward(kernel, q, k, v, dout, lse, di)
    dk = torch.empty((b, skv, h, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    _call(kernel, _BWD_DKV_ARGTYPES, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          b, h, q.shape[1], skv, d, *_strides(q, k, v, dout, dk, dv), float(scale),
          source="flash_attention_bwd")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor, di: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """dQ = scale ds k of ``flash_attention``'s attention on the card (csrc/
    flash_attention_bwd.cu, entry point flash_attention_bwd_dq), (B, Sq, H,
    D) bf16; takes what ``flash_attention_bwd_dkv`` takes.  Counts each
    launch in ``flash_attention_bwd_dq.launches``."""
    kernel = "flash_attention_bwd_dq"
    b, sq, skv, h, d = _check_backward(kernel, q, k, v, dout, lse, di)
    dq = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
    _call(kernel, _BWD_DQ_ARGTYPES, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
          b, h, sq, skv, d, *_strides(q, k, v, dout, dq), float(scale),
          source="flash_attention_bwd")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


# ----------------------------------------------------------------------------
# the quantized attention kernels (csrc/flash_pv8.cu, csrc/int8_flash_attention.cu)
# ----------------------------------------------------------------------------

_PV8_ARGTYPES = (_INT, *[_PTR] * 5, *[_INT] * 6, *[_LONG] * 10, ctypes.c_float, _PTR)
_INT8_ATTN_ARGTYPES = (_INT, *[_PTR] * 6, *[_INT] * 6, *[_LONG] * 10, _PTR)


def _check_vt(kernel: str, vt: torch.Tensor, b: int, h: int, d: int, skv: int,
              device: torch.device, tile: int) -> None:
    """V quantized and laid out for the int8 PV product: (B * H, D, L) int8,
    contiguous, with L a multiple of the kernel's key ``tile`` that covers
    Skv (the keys past Skv zero)."""
    if vt.dim() != 3:
        raise ValueError(f"{kernel}: v8 must be (B*H, D, L), got shape {tuple(vt.shape)}")
    _check_tensor(kernel, "v8", vt, torch.int8, (b * h, d, vt.shape[2]), device)
    _check_dense(kernel, "v8", vt)
    if vt.shape[2] % tile or vt.shape[2] < skv:
        raise ValueError(f"{kernel}: v8 holds {vt.shape[2]} keys per row; it needs a "
                         f"multiple of {tile} that covers Skv={skv}")


def _check_per_head(kernel: str, name: str, x: torch.Tensor, n: int,
                    device: torch.device) -> None:
    _check_tensor(kernel, name, x, torch.float32, (n,), device)
    _check_dense(kernel, name, x)


def _check_block_k(kernel: str, block_k: int, tile: int) -> None:
    """A key block is a whole number of the kernel's key tiles."""
    if block_k <= 0 or block_k % tile:
        raise ValueError(f"{kernel}: block_k {block_k} must be a positive multiple of {tile}")


def flash_pv8(q: torch.Tensor, k: torch.Tensor, v8: torch.Tensor, vs: torch.Tensor,
              scale_log2: float, block_k: int) -> torch.Tensor:
    """PV-int8 attention on the card (csrc/flash_pv8.cu): bf16 q k^T, the
    softmax weights of each ``block_k``-key block (a multiple of
    ``PV8_KEY_TILE``) quantized to int8 against the block's row max, int8 PV.
    q (B, Sq, H, D), k (B, Skv, H, D) bf16; v8 the per-(batch, head) int8 V
    as ``ops/attention_variants.py pv8_keys_last`` lays it out (its key order
    cannot be checked here), vs (B * H,) fp32 its scales; ``scale_log2`` the
    softmax scale times log2(e).  -> (B, Sq, H, D) bf16.  Counts each launch
    in ``flash_pv8.launches``."""
    kernel = "flash_pv8"
    b, sq, skv, h, d = _check_attention(kernel, q, k, None)
    _check_vt(kernel, v8, b, h, d, skv, q.device, PV8_KEY_TILE)
    _check_per_head(kernel, "vs", vs, b * h, q.device)
    _check_block_k(kernel, block_k, PV8_KEY_TILE)
    out = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
    _call(kernel, _PV8_ARGTYPES, q.device, q.data_ptr(), k.data_ptr(), v8.data_ptr(),
          vs.data_ptr(), out.data_ptr(), b, h, sq, skv, d, block_k, *_strides(q, k),
          v8.shape[2], *_strides(out), float(scale_log2))
    flash_pv8.launches += 1
    return out


flash_pv8.launches = 0


def int8_flash_attention(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                         logit_scale: torch.Tensor, v_scale: torch.Tensor,
                         block_k: int) -> torch.Tensor:
    """int8 flash attention on the card (csrc/int8_flash_attention.cu, on
    the PV-int8 loop): q8 (B, Sq, H, D) and k8 (B, Skv, H, D) int8 codes; v8
    the per-(batch, head) int8 V as ``ops/attention_variants.py
    pv8_keys_last`` lays it out (its key order cannot be checked here);
    logit_scale (B * H,) = qs * ks * softmax scale and v_scale (B * H,) = vs
    / 127, fp32; online softmax per ``block_k``-key block (a multiple of
    ``PV8_KEY_TILE``).  -> (B, Sq, H, D) bf16.  Counts each launch in
    ``int8_flash_attention.launches``."""
    kernel = "int8_flash_attention"
    b, sq, skv, h, d = _check_attention(kernel, q8, k8, None, dtype=torch.int8)
    _check_vt(kernel, v8, b, h, d, skv, q8.device, PV8_KEY_TILE)
    _check_per_head(kernel, "logit_scale", logit_scale, b * h, q8.device)
    _check_per_head(kernel, "v_scale", v_scale, b * h, q8.device)
    _check_block_k(kernel, block_k, PV8_KEY_TILE)
    out = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q8.device)
    _call(kernel, _INT8_ATTN_ARGTYPES, q8.device, q8.data_ptr(), k8.data_ptr(), v8.data_ptr(),
          logit_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), b, h, sq, skv, d,
          block_k, *_strides(q8, k8), v8.shape[2], *_strides(out))
    int8_flash_attention.launches += 1
    return out


int8_flash_attention.launches = 0


# ----------------------------------------------------------------------------
# the int8 GEMM family (csrc/int8_*.cu)
# ----------------------------------------------------------------------------

# K per shared-memory stage of the wgmma main loop (kBlockK of
# csrc/int8_gemm_hopper.cuh): a K group of int8_gemm_gscale is a multiple of it
INT8_TILE_K = 128
# a group of int8_gemm_gelu_quant is a whole number of its narrower block
# tile's columns (csrc/int8_gemm_gelu_quant.cu: 128 x 256 tiles where the
# group is a multiple of 256, else 128 x 128); a cluster of blocks along N
# covers one group
INT8_TILE_N = 128
INT8_MAX_GROUP = 1024

_QUANT_ARGTYPES = (_INT, _PTR, _PTR, _PTR, _INT, _INT, _LONG, _PTR)
_GEMM_ARGTYPES = (_INT, *[_PTR] * 6, _INT, _INT, _INT, _LONG, _LONG, _PTR)
_GELU_QUANT_ARGTYPES = (_INT, *[_PTR] * 7, _INT, _INT, _INT, _LONG, _LONG, _INT, _PTR)
_GSCALE_ARGTYPES = (_INT, *[_PTR] * 6, _INT, _INT, _INT, _LONG, _LONG, _INT, _PTR)


def _check_tensor(kernel: str, name: str, x: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{kernel} takes CUDA tensors on one device; {name} is on {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{kernel} takes {name} as {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")


def _check_rows(kernel: str, name: str, x: torch.Tensor) -> None:
    """The kernels move rows as 16-byte vectors, or by TMA, which takes
    16-byte aligned base addresses and row strides."""
    if x.stride(-1) != 1 or (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} needs dense, 16-byte aligned rows "
                         f"(strides {x.stride()}, data pointer {x.data_ptr():#x})")


def _check_dense(kernel: str, name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous, strides {x.stride()}")


def _check_gemm(kernel: str, xq: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias) -> tuple:
    """Check the operands every int8 GEMM takes: xq (M, K) and wq (N, K) int8
    with 16-byte aligned rows, ws (N,) fp32, bias None or (N,); returns
    (M, N, K, bias as a dense fp32 tensor or None)."""
    device = xq.device
    if xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"{kernel} takes 2-D xq and wq, got {tuple(xq.shape)}, {tuple(wq.shape)}")
    m, k = xq.shape
    n = wq.shape[0]
    _check_tensor(kernel, "xq", xq, torch.int8, (m, k), device)
    _check_tensor(kernel, "wq", wq, torch.int8, (n, k), device)
    _check_tensor(kernel, "ws", ws, torch.float32, (n,), device)
    for name, x in (("xq", xq), ("wq", wq)):
        _check_rows(kernel, name, x)
    _check_dense(kernel, "ws", ws)
    if m == 0 or k % 16 or n % 16 or k == 0 or n == 0:
        raise ValueError(f"{kernel}: unsupported sizes M={m}, K={k}, N={n} "
                         "(K and N must be positive multiples of 16)")
    if bias is not None:
        _check_tensor(kernel, "bias", bias, bias.dtype, (n,), device)
        if not bias.is_floating_point():
            raise ValueError(f"{kernel} takes a floating bias, got {bias.dtype}")
        bias = bias.float().contiguous()
    return m, n, k, bias


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def int8_quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization on the card (csrc/
    int8_quantize_rows.cu): (M, K) bf16 -> ((M, K) int8, (M,) fp32 scales).
    K a multiple of 8, rows 16-byte aligned.  Counts each launch in
    ``int8_quantize_rows.launches``."""
    kernel = "int8_quantize_rows"
    if x.dim() != 2:
        raise ValueError(f"{kernel} takes (M, K), got shape {tuple(x.shape)}")
    m, k = x.shape
    _check_tensor(kernel, "x", x, torch.bfloat16, (m, k), x.device)
    _check_rows(kernel, "x", x)
    if m == 0 or k == 0 or k % 8:
        raise ValueError(f"{kernel}: unsupported sizes M={m}, K={k} (K a positive multiple of 8)")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    _call(kernel, _QUANT_ARGTYPES, x.device, x.data_ptr(), xq.data_ptr(), xs.data_ptr(),
          m, k, x.stride(0))
    int8_quantize_rows.launches += 1
    return xq, xs


int8_quantize_rows.launches = 0


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(xq @ wq^T) * xs[:, None] * ws[None, :] + bias on the card (csrc/
    int8_gemm.cu): xq (M, K), wq (N, K) int8, xs (M,) and ws (N,) fp32 ->
    (M, N) bf16.  Counts each launch in ``int8_gemm.launches``."""
    kernel = "int8_gemm"
    m, n, k, bias = _check_gemm(kernel, xq, wq, ws, bias)
    _check_tensor(kernel, "xs", xs, torch.float32, (m,), xq.device)
    _check_dense(kernel, "xs", xs)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    _call(kernel, _GEMM_ARGTYPES, xq.device, xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
          ws.data_ptr(), _ptr(bias), out.data_ptr(), m, n, k, xq.stride(0), wq.stride(0))
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def int8_gemm_gelu_quant(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                         ws: torch.Tensor, bias: Optional[torch.Tensor], group: int):
    """The fused FF's first GEMM on the card (csrc/int8_gemm_gelu_quant.cu):
    tanh-gelu of the dequantized product plus bias, re-quantized per (row,
    ``group`` columns) -> ((M, N) int8, (M, N / group) fp32).  ``group`` a
    multiple of 128 up to 1,024 that divides N.  Counts each launch in
    ``int8_gemm_gelu_quant.launches``."""
    kernel = "int8_gemm_gelu_quant"
    m, n, k, bias = _check_gemm(kernel, xq, wq, ws, bias)
    _check_tensor(kernel, "xs", xs, torch.float32, (m,), xq.device)
    _check_dense(kernel, "xs", xs)
    if group % INT8_TILE_N or not 0 < group <= INT8_MAX_GROUP or n % group:
        raise ValueError(f"{kernel}: group {group} must be a multiple of {INT8_TILE_N} up to "
                         f"{INT8_MAX_GROUP} that divides N={n}")
    hq = torch.empty((m, n), dtype=torch.int8, device=xq.device)
    hs = torch.empty((m, n // group), dtype=torch.float32, device=xq.device)
    _call(kernel, _GELU_QUANT_ARGTYPES, xq.device, xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
          ws.data_ptr(), _ptr(bias), hq.data_ptr(), hs.data_ptr(), m, n, k, xq.stride(0),
          wq.stride(0), group)
    int8_gemm_gelu_quant.launches += 1
    return hq, hs


int8_gemm_gelu_quant.launches = 0


def int8_gemm_gscale(hq: torch.Tensor, wq: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                     bias: Optional[torch.Tensor], group: int) -> torch.Tensor:
    """The fused FF's second GEMM on the card (csrc/int8_gemm_gscale.cu): hq
    (M, K) int8 with scales hs (M, K / group) fp32 per (row, ``group`` of K),
    wq (N, K) int8 -> (M, N) bf16.  ``group`` a multiple of ``INT8_TILE_K``
    (128) that divides K.  Counts each launch in
    ``int8_gemm_gscale.launches``."""
    kernel = "int8_gemm_gscale"
    m, n, k, bias = _check_gemm(kernel, hq, wq, ws, bias)
    if group <= 0 or group % INT8_TILE_K or k % group:
        raise ValueError(f"{kernel}: group {group} must be a multiple of {INT8_TILE_K} "
                         f"that divides K={k}")
    _check_tensor(kernel, "hs", hs, torch.float32, (m, k // group), hq.device)
    _check_dense(kernel, "hs", hs)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=hq.device)
    _call(kernel, _GSCALE_ARGTYPES, hq.device, hq.data_ptr(), wq.data_ptr(), hs.data_ptr(),
          ws.data_ptr(), _ptr(bias), out.data_ptr(), m, n, k, hq.stride(0), wq.stride(0), group)
    int8_gemm_gscale.launches += 1
    return out


int8_gemm_gscale.launches = 0
