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

import torch

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_ROOT = _PACKAGE_DIR.parent / "build" / "trajectorycrafter_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
FLASH_HEAD_DIMS = (64, 128)
FLASH_KEY_TILE = 64  # keys per shared-memory tile (kBlockN in both csrc/ kernels)


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


def build_library(source_name: str) -> dict:
    """Compile ``csrc/<source_name>`` unless a build of the same source and
    flags exists.  Returns {"path", "seconds" (0.0 when cached), "log"}."""
    source = CSRC_DIR / source_name
    # the key covers the shared headers too: a source includes them
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
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


_STRIDES = [ctypes.c_longlong] * 12  # (batch, sequence, head) strides of q, k, v, out


@functools.lru_cache(maxsize=None)
def _library(name: str, n_ptrs: int) -> ctypes.CDLL:
    """Build and load ``csrc/<name>.cu``, whose entry point is ``<name>_fwd``:
    (device, ``n_ptrs`` pointers -- q, k, v, out and any scratch -- batch,
    heads, sq, skv, head_dim, strides..., scale, stream) -> cudaError_t."""
    lib = ctypes.CDLL(str(build_library(f"{name}.cu")["path"]))
    fwd = getattr(lib, f"{name}_fwd")
    fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                    + _STRIDES + [ctypes.c_float, ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check_bshd(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, S, H, D), got shape {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must be dense in the head dim, strides {x.stride()}")
    # the kernel moves rows as 16-byte vectors
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs 16-byte aligned rows (strides {x.stride()} must be "
            "multiples of 8 elements and the data pointer 16-byte aligned)")


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """Check q, k, v (B, S, H, D) as both kernels take them, launch
    ``kernel`` into a new output and raise on a nonzero launch status."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{kernel} takes CUDA tensors; {name} is on {x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{kernel} takes bf16; {name} is {x.dtype}")
        _check_bshd(name, x)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
    if sq == 0 or skv == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes: B*H={b * h}, Sq={sq}, Skv={skv}")

    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    # the two-pass kernel keeps its row maxima in an fp32 scratch
    scratch = ([torch.empty(b * h * sq, dtype=torch.float32, device=q.device)]
               if kernel == "flash_maxpass" else [])
    lib = _library(kernel, 4 + len(scratch))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = getattr(lib, f"{kernel}_fwd")(
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in scratch),
        b, h, sq, skv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        float(scale), stream)
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + getattr(lib, f"{kernel}_error_string")(status).decode())
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
    row max of the scaled scores first, then exp2 attention against it.
    Takes what ``flash_attention`` takes.  Counts each call, which launches
    both passes, in ``flash_maxpass.launches``."""
    out = _launch("flash_maxpass", q, k, v, scale)
    flash_maxpass.launches += 1
    return out


flash_maxpass.launches = 0
