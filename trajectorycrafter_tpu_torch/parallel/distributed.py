"""The process group of a sharded run, and every hop and collective of it.

The JAX package gets its devices and collectives from ``jax`` itself; the
port runs one process per rank under ``torch.distributed``, started by
``torchrun``:

    torchrun --nproc_per_node N -m trajectorycrafter_tpu_torch.cli \\
        --mesh_dp D --mesh_sp S --mesh_tp T [--dist_backend nccl|gloo] ...

``init_from_env`` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and puts local rank
r of L on ``cuda:r`` when the host has a card a rank, and on ``cuda:(r * C
// L)`` when its C cards are fewer, so that L / C ranks share each card;
``init`` takes the rank, world size, address and device from the caller
(the CPU tests start gloo worlds by ``file://``).  The caller names the
backend: ``nccl`` across cards, or ``gloo``, on the CPU or for ranks that
share one card (NCCL refuses two ranks on one device, so it raises there).
A backend that does not start raises; no other backend is tried.

Every hop and collective of the port goes through this module.  Under gloo
a CUDA tensor is staged through pinned host memory (copied to the host,
sent there, copied back) for every operation that gloo does not run on CUDA
tensors itself: ``GLOO_CUDA_OPS`` lists the ones it does.  torch's backend
table lists ``all_reduce`` and ``broadcast``; tools/gloo_cuda_probe.py on
an H100 (torch 2.11) found ``all_gather`` running too, and send / recv
ending the process, so the hops (``Shift``) are staged.  ``TRANSPORT`` counts
the calls and bytes of each operation by the transport that ran it
(``direct`` or ``staged``); a caller may file a collective under a name of
its own (parallel/spatial.py: ``halo``, ``norm``, ``slabs``; ops/splat.py:
``warp``; parallel/pipeline.py: ``stage``, the GPipe hop between stages).

Training differentiates through the tensor-parallel layers, and a
collective that writes into fresh buffers cuts the graph.  ``tp_input``
and ``tp_output`` are the two autograd-aware tp collectives: a
column-parallel layer's input (the identity forward, the sum over tp of the
gradient backward) and a row-parallel layer's output (``sum_partials``
forward, the identity backward).  Both reduce in coordinate order, so every
tp rank holds the same bits.  ``gather_tokens`` is the sp one: the token
shards joined on every rank, and backward this rank's slice of the
gradient, not its sum over sp (every sp rank computes the same loss on the
whole output, so each already holds the whole gradient).

The groups of a mesh (parallel/mesh.py) wait ``GROUP_TIMEOUT`` for a peer,
well under the world's ``TIMEOUT``: where a caller started the world (a
test's gloo world, the smoke's torchrun world) a rank that failed would
otherwise hold every peer in its sub-group's collective for 20 minutes.
"""

from __future__ import annotations

import os
import socket
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

BACKENDS = ("nccl", "gloo")
# the operations gloo runs on CUDA tensors itself; the others are staged
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather")
TIMEOUT = timedelta(minutes=20)
GROUP_TIMEOUT = timedelta(minutes=5)
# "<op> <direct|staged>" -> calls, "<op> <direct|staged> bytes" -> bytes sent
TRANSPORT: Counter = Counter()


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its ``size``, this rank's
    coordinate ``index`` along it, the global ranks along it by coordinate,
    and their process group (None when the axis has one rank)."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: object = None

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` coordinates away along the axis, cyclically."""
        return self.ranks[(self.index + offset) % self.size]


def init(backend: str, rank: int, world_size: int, init_method: str,
         device) -> torch.device:
    """Start the process group: rank ``rank`` of ``world_size`` at
    ``init_method`` (``env://``, ``tcp://host:port`` or ``file://path``) on
    ``backend``, computing on ``device``.  Raises if it does not start."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not {device}")
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
        # NCCL makes its communicator at the first collective: make it now,
        # so that a backend that cannot run fails here
        probe = torch.zeros(1, device=device)
        dist.all_reduce(probe)
    except Exception as e:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(f"the {backend} process group did not start ({e}); "
                           "no other backend is tried") from e
    return device


def init_from_env(backend: str = "nccl", device: Optional[str] = None) -> torch.device:
    """Start the process group from torchrun's environment.  The rank's
    device is its card (see the module's doc) unless the caller passes one
    (``"cpu"``); ranks that share a card run only under gloo."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(f"no torchrun environment ({', '.join(missing)} unset): start the "
                           "ranks with torchrun --nproc_per_node N")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device is None:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA card is visible: pass the CPU as the device")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > cards:
            raise ValueError(f"NCCL refuses two ranks on one card (duplicate GPU): "
                             f"{local_world} ranks on {cards} cards need --dist_backend gloo")
        device = f"cuda:{local * min(cards, local_world) // local_world}"
    return init(backend, rank, world, "env://", device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_axis() -> Axis:
    """Every rank of the process group, as one axis."""
    world, rank = dist.get_world_size(), dist.get_rank()
    return Axis("world", world, rank, tuple(range(world)), dist.group.WORLD)


def _staged(x: torch.Tensor, op: str) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo" and op not in GLOO_CUDA_OPS


def _record(op: str, staged: bool, nbytes: int) -> None:
    how = "staged" if staged else "direct"
    TRANSPORT[f"{op} {how}"] += 1
    TRANSPORT[f"{op} {how} bytes"] += nbytes


def _host(x: torch.Tensor) -> torch.Tensor:
    """A dense host copy of ``x``, in pinned memory when ``x`` is on the card
    (waits for the device)."""
    if not x.is_cuda:
        return x.detach().contiguous()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x.detach())
    return buf


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum",
               name: str = "all_reduce") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``x`` over ``axis``; reduces a dense
    ``x`` in place and returns the result.  ``name``: the operation's
    name in ``TRANSPORT``."""
    if axis.size == 1:
        return x
    staged = _staged(x, "all_reduce")
    buf = _host(x) if staged else x.contiguous()
    dist.all_reduce(buf, _OPS[op], group=axis.group)
    _record(name, staged, buf.numel() * buf.element_size())
    return buf.to(x.device) if staged else buf


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               sizes: Optional[Sequence[int]] = None, name: str = "all_gather") -> torch.Tensor:
    """The pieces of every rank along ``axis`` joined along ``dim``, in
    coordinate order.  ``sizes`` gives each rank's extent along ``dim``
    where they differ: each piece is zero-padded to the largest for the
    transfer and cut back after.  ``name``: the operation's name in
    ``TRANSPORT``."""
    if axis.size == 1:
        return x
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * axis.size
    width = max(sizes)
    if x.shape[dim] < width:
        pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, width - x.shape[dim]]
        x = F.pad(x, pad)
    staged = _staged(x, "all_gather")
    buf = _host(x) if staged else x.contiguous()
    pieces = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(pieces, buf, group=axis.group)
    _record(name, staged, buf.numel() * buf.element_size())
    out = torch.cat([p.narrow(dim, 0, n) for p, n in zip(pieces, sizes)], dim=dim)
    return out.to(x.device) if staged else out


def sum_partials(partial: torch.Tensor, axis: Axis,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row-parallel layer's output: every rank's ``partial`` along
    ``axis`` summed in fp32 in coordinate order (the same bits on every
    rank), plus ``bias`` once, in the partial's dtype.  The partials travel
    in their own dtype (an all_gather): a bf16 partial in fp32 would double
    the bytes and carry nothing more."""
    parts = all_gather(partial.unsqueeze(0), axis, dim=0) if axis.size > 1 else [partial]
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(partial.dtype)


class _TpInput(torch.autograd.Function):
    """A column-parallel layer's input: the identity forward; backward, the
    sum over tp of the ranks' gradients, each of which holds only its
    columns' part."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return tp_input_grad(grad, ctx.axis), None


def tp_input_grad(grad: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The backward of ``tp_input``: the ranks' gradients summed in fp32 in
    coordinate order."""
    return sum_partials(grad.contiguous(), axis)


class _TpOutput(torch.autograd.Function):
    """A row-parallel layer's output, ``sum_partials`` of the partials and
    the bias; backward, every rank's partial gets the whole gradient."""

    @staticmethod
    def forward(ctx, partial, bias, axis):
        ctx.bias_shape = None if bias is None else bias.shape
        return sum_partials(partial, axis, bias)

    @staticmethod
    def backward(ctx, grad):
        grad_bias = None
        if ctx.needs_input_grad[1]:
            grad_bias = grad.reshape(-1, grad.shape[-1]).sum(0).reshape(ctx.bias_shape)
        return grad, grad_bias, None


def tp_input(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x`` as the input of column-parallel layers over ``axis``: with grad
    enabled, the sum over tp of its gradient in the backward pass.  One call
    serves every layer that reads ``x`` (q, k and v)."""
    if axis is None or axis.size == 1 or not torch.is_grad_enabled():
        return x
    return _TpInput.apply(x, axis)


def tp_output(partial: torch.Tensor, axis: Axis,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row-parallel layer's output, ``sum_partials``; with grad enabled
    through an autograd Function whose backward hands every partial the
    whole gradient."""
    if not torch.is_grad_enabled():
        return sum_partials(partial, axis, bias)
    return _TpOutput.apply(partial, bias, axis)


class _GatherTokens(torch.autograd.Function):
    """The token shards of every rank along sp joined along ``dim``;
    backward, this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, axis, dim, sizes):
        ctx.dim, ctx.lo, ctx.n = dim, sum(sizes[:axis.index]), sizes[axis.index]
        return all_gather(x, axis, dim=dim, sizes=sizes)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None


def gather_tokens(x: torch.Tensor, axis: Axis, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """Every sp rank's token shard (``sizes`` tokens each along ``dim``)
    joined in coordinate order on every rank; with grad enabled the backward
    pass hands each rank its own slice of the gradient: every sp rank
    computes the same loss on the joined tokens, so each already holds the
    whole gradient, and a sum over sp would count it ``axis.size`` times."""
    if axis.size == 1:
        return x
    return _GatherTokens.apply(x, axis, dim, list(sizes))


def ranks_on_device(axis: Axis, device) -> int:
    """How many ranks of ``axis`` compute on this rank's ``device`` (the
    same host and device), this one included: they share its memory."""
    if axis.size == 1:
        return 1
    mine = (socket.gethostname(), str(torch.device(device)))
    everyone = [None] * axis.size
    dist.all_gather_object(everyone, mine, group=axis.group)
    return sum(d == mine for d in everyone)


def barrier(axis: Axis) -> None:
    """Every rank of ``axis`` waits here for the others."""
    if axis.size > 1:
        dist.barrier(group=axis.group)


def broadcast(x: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src`` on every rank of ``axis``."""
    if axis.size == 1:
        return x
    staged = _staged(x, "broadcast")
    buf = _host(x) if staged else x.contiguous()
    dist.broadcast(buf, axis.ranks[src], group=axis.group)
    _record("broadcast", staged, buf.numel() * buf.element_size())
    return buf.to(x.device) if staged else buf


def broadcast_object(obj, axis: Axis, src: int = 0):
    """The picklable ``obj`` of the rank at coordinate ``src`` on every rank
    of ``axis``; the other ranks pass anything (None)."""
    if axis.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, axis.ranks[src], group=axis.group)
    return box[0]


def broadcast_tensors(tensors: Optional[List[Optional[torch.Tensor]]], axis: Axis,
                      device, src: int = 0) -> list:
    """The list ``tensors`` of the rank at coordinate ``src`` (None entries
    allowed) on every rank of ``axis``, on ``device``; the other ranks pass
    None.  Shapes and dtypes travel first."""
    if axis.size == 1:
        return list(tensors)
    meta = [None if tensors is None else
            [None if t is None else (tuple(t.shape), t.dtype) for t in tensors]]
    dist.broadcast_object_list(meta, axis.ranks[src], group=axis.group)
    out = []
    for i, m in enumerate(meta[0]):
        if m is None:
            out.append(None)
            continue
        t = tensors[i].to(device) if axis.index == src else torch.empty(m[0], dtype=m[1],
                                                                        device=device)
        out.append(broadcast(t, axis, src))
    return out


class Shift:
    """One shift along an axis: this rank's tensors go to the next rank
    along it while the previous rank's arrive in tensors of ``recv_shapes``
    and ``dtypes`` (by default the sent tensors'): a ring's hop
    (ops/ring_attention.py), or a pipeline's between neighbouring stages
    (parallel/pipeline.py), where the first stage receives nothing and the
    last sends nothing.  Posted at construction; ``wait`` returns the
    arrived tensors on ``device``.  Empty tensors do not travel (both ends
    know the shapes).  Filed in ``TRANSPORT`` under ``name``."""

    def __init__(self, tensors: Sequence[torch.Tensor], axis: Axis, recv_shapes, device,
                 dtypes=None, name: str = "p2p"):
        self.device = device
        # gloo's send / recv end the process on CUDA tensors: staged
        self.staged = torch.device(device).type == "cuda" and dist.get_backend() == "gloo"
        send = [_host(t) if self.staged else t.contiguous() for t in tensors]
        where = dict(device="cpu", pin_memory=True) if self.staged else dict(device=device)
        dtypes = dtypes or [t.dtype for t in tensors]
        self.recv = [torch.empty(s, dtype=d, **where) for s, d in zip(recv_shapes, dtypes)]
        ops = [dist.P2POp(dist.isend, t, axis.peer(1), axis.group) for t in send if t.numel()]
        ops += [dist.P2POp(dist.irecv, t, axis.peer(-1), axis.group)
                for t in self.recv if t.numel()]
        self._send = send  # alive until the shift is done
        self.works = dist.batch_isend_irecv(ops) if ops else []
        if send:
            _record(name, self.staged, sum(t.numel() * t.element_size() for t in send))

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        self._send = None
        if not self.staged:
            return self.recv
        return [t.to(self.device, non_blocking=True) for t in self.recv]
