"""Plain PyTorch reference of one CFG DDIM_Origin step of the CrossTransformer3D
DiT, in float32, one unit at a time.

Written from the model's published equations (CogVideoX blocks: AdaLN-Zero,
joint text + video self-attention with per-head QK layer norm and 3D RoPE on
the video tokens, tanh-gelu feed-forward; a Perceiver cross-attention onto
the reference-view tokens after every second block, added to the residual;
the final norm over the joint stream, AdaLN and the projection).  It imports
nothing of the program and takes no tensor the program made: each unit's
weights are drawn again from the seed (benchmark/weights.py) as the unit is
reached, so the whole model never sits on the device at once.

``precision`` says how the linear layers and attention compute:

- ``"fp32"``: everything in float32 (TF32 off), the reference of a bf16
  configuration;
- ``"int8"``: the blocks' and Perceivers' linear layers in the int8 scheme
  the configuration states (weights per output channel and activations per
  row, symmetric, codes round-half-even of value / (max |value| / 127)), the
  integer product exact (float64), rescaled in float32; the rest float32;
- ``"int4"`` and ``"fp8"``: the controls, one precision below: the same
  scheme with codes in [-7, 7], and every linear layer's and attention's
  inputs rounded to float8 e4m3 under a scale per row (per output channel
  for weights, per head for q, k and v).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "int8", "int4", "fp8")
# the layers the int8 configuration quantizes, within their unit
QUANTIZED = {"attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0", "ff.net.0.proj",
             "ff.net.2", "to_q", "to_kv", "to_out"}
ROW_CHUNK = 8192  # rows of a linear layer's input per product
SCORE_BYTES = 1 << 30  # bound of one block of attention scores


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division (a tensor by a 0-d tensor)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _symmetric_codes(x: torch.Tensor, levels: int, floor: float):
    """Rows of x -> (codes as float, scale per row): scale max(|row|, floor) / levels."""
    scale = _div(x.abs().amax(dim=-1, keepdim=True).clamp_min(floor), float(levels))
    return torch.clamp(torch.round(x / scale), -levels, levels), scale


def _fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale per slice along ``dim`` (max |x| -> 448)."""
    scale = _div(x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12), 448.0)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linears:
    """Applies a linear layer in the reference's ``precision``."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 name: str) -> torch.Tensor:
        lead, w = x.shape[:-1], w.float()
        x = x.reshape(-1, x.shape[-1])
        levels = {"int8": 127, "int4": 7}.get(self.precision)
        if levels is not None and name in QUANTIZED:
            wq, ws = _symmetric_codes(w, levels, 1e-12)
            wq64 = wq.double()
            out = torch.cat([self._integer(x[i:i + ROW_CHUNK], wq64, ws, levels)
                             for i in range(0, x.shape[0], ROW_CHUNK)])
        elif self.precision == "fp8":
            out = _fp8(x) @ _fp8(w).T
        else:
            out = x @ w.T
        if b is not None:
            out = out + b.float()
        return out.reshape(*lead, w.shape[0])

    @staticmethod
    def _integer(x, wq64, ws, levels):
        xq, xs = _symmetric_codes(x, levels, 1e-8)
        acc = (xq.double() @ wq64.T).float()  # exact: every partial sum is an integer < 2^53
        return (acc * xs) * ws[:, 0][None, :]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              fp8: bool = False) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Skv, H, D) -> (B, Sq, H * D) softmax attention in
    float32, in blocks of queries and heads that bound the score block."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))  # (B, H, S, D)
    if fp8:
        qt, kt, vt = (_fp8(x, dim=(-2, -1)) for x in (qt, kt, vt))
    qt = qt * scale  # once, not on every block of scores
    out = torch.empty(b, h, sq, d, device=q.device)
    heads = max(1, min(h, SCORE_BYTES // (4 * skv * min(sq, 1024))))
    rows = max(1, min(sq, SCORE_BYTES // (4 * skv * heads)))
    for bi in range(b):
        for h0 in range(0, h, heads):
            kh, vh = kt[bi, h0:h0 + heads], vt[bi, h0:h0 + heads]
            for r0 in range(0, sq, rows):
                scores = torch.matmul(qt[bi, h0:h0 + heads, r0:r0 + rows], kh.transpose(-1, -2))
                p = torch.softmax(scores, dim=-1)
                if fp8:
                    p = _fp8(p)
                out[bi, h0:h0 + heads, r0:r0 + rows] = torch.matmul(p, vh)
    return out.transpose(1, 2).reshape(b, sq, h * d)


def layer_norm(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str, eps: float):
    pre = f"{prefix}." if prefix else ""
    return F.layer_norm(x, x.shape[-1:], w[f"{pre}weight"].float(), w[f"{pre}bias"].float(), eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features, cosines first (flip_sin_to_cos, no frequency shift)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    angles = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)


def rope_tables(head_dim: int, height: int, width: int, frames: int, patch: int,
                spatial: int = 8, base: Tuple[int, int] = (480, 720), theta: float = 10000.0):
    """CogVideoX 3D RoPE: head channels t : h : w = 1/4 : 3/8 : 3/8, the grid
    crop-fitted into the 480x720 base grid, frequencies repeated over each
    interleaved pair.  -> (cos, sin), each (frames * h * w, head_dim) float32."""
    gh, gw = height // (spatial * patch), width // (spatial * patch)
    bh, bw = base[0] // (spatial * patch), base[1] // (spatial * patch)
    if gh / gw > bh / bw:
        rh, rw = bh, int(round(bh / gh * gw))
    else:
        rw, rh = bw, int(round(bw / gw * gh))
    top, left = int(round((bh - rh) / 2.0)), int(round((bw - rw) / 2.0))
    pos_h = np.linspace(top, top + rh, gh, endpoint=False, dtype=np.float32)
    pos_w = np.linspace(left, left + rw, gw, endpoint=False, dtype=np.float32)
    pos_t = np.arange(frames, dtype=np.float32)

    def axis(dim, pos):
        freqs = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
        angles = np.outer(pos, freqs)
        return np.repeat(np.cos(angles), 2, axis=1), np.repeat(np.sin(angles), 2, axis=1)

    dt, dh = head_dim // 4, head_dim // 8 * 3
    parts = [axis(dt, pos_t), axis(dh, pos_h), axis(dh, pos_w)]
    shape = (frames, gh, gw)

    def grid(i):
        t, h, w = (p[i] for p in parts)
        return np.concatenate([
            np.broadcast_to(t[:, None, None], shape + (dt,)),
            np.broadcast_to(h[None, :, None], shape + (dh,)),
            np.broadcast_to(w[None, None, :], shape + (dh,))], axis=-1).reshape(-1, head_dim)

    return (torch.from_numpy(grid(0).astype(np.float32)),
            torch.from_numpy(grid(1).astype(np.float32)))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs: (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin)."""
    pairs = x.unflatten(-1, (-1, 2))
    turned = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + turned * sin


def patchify(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(B, F, H, W, C) -> (B, F * H/p * W/p, dim): the patch convolution."""
    bs, f, h, wd, c = x.shape
    y = F.conv2d(x.reshape(bs * f, h, wd, c).permute(0, 3, 1, 2), w.float(), b.float(), stride=p)
    return y.flatten(2).transpose(1, 2).reshape(bs, -1, y.shape[1])


class ReferenceDiT:
    """The DiT's forward, its weights drawn unit by unit by ``weights(unit)``."""

    def __init__(self, cfg: dict, weights: Callable[[str], Dict[str, torch.Tensor]],
                 precision: str):
        self.cfg, self.weights, self.linear = cfg, weights, Linears(precision)
        self.fp8 = precision == "fp8"

    def _lin(self, x, w, name, bias=True):
        pre = f"{name}." if name else ""
        return self.linear(x, w[f"{pre}weight"], w[f"{pre}bias"] if bias else None, name)

    def _block(self, w, hidden, encoder, temb, rope):
        cfg = self.cfg
        heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
        tl = encoder.shape[1]

        def modulate(norm):
            mod = self._lin(F.silu(temb), w, f"{norm}.linear")
            shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
            h = layer_norm(hidden, w, f"{norm}.norm", 1e-5) * (1 + scale[:, None]) + shift[:, None]
            e = layer_norm(encoder, w, f"{norm}.norm", 1e-5) * (1 + e_scale[:, None]) \
                + e_shift[:, None]
            return torch.cat([e, h], dim=1), gate[:, None], e_gate[:, None]

        x, gate, e_gate = modulate("norm1")
        q = layer_norm(self._lin(x, w, "attn1.to_q").unflatten(-1, (heads, hd)), w,
                       "attn1.norm_q", 1e-6)
        k = layer_norm(self._lin(x, w, "attn1.to_k").unflatten(-1, (heads, hd)), w,
                       "attn1.norm_k", 1e-6)
        v = self._lin(x, w, "attn1.to_v").unflatten(-1, (heads, hd))
        cos, sin = rope[0][:, None], rope[1][:, None]
        q = torch.cat([q[:, :tl], rotate(q[:, tl:], cos, sin)], dim=1)
        k = torch.cat([k[:, :tl], rotate(k[:, tl:], cos, sin)], dim=1)
        out = self._lin(attention(q, k, v, hd ** -0.5, self.fp8), w, "attn1.to_out.0")
        hidden = hidden + gate * out[:, tl:]
        encoder = encoder + e_gate * out[:, :tl]

        x, gate, e_gate = modulate("norm2")
        ff = self._lin(F.gelu(self._lin(x, w, "ff.net.0.proj"), approximate="tanh"), w,
                       "ff.net.2")
        return hidden + gate * ff[:, tl:], encoder + e_gate * ff[:, :tl]

    def _perceiver(self, w, cross_tokens, hidden):
        cfg = self.cfg
        heads, hd = cfg["cross_attn_num_heads"], cfg["cross_attn_dim_head"]
        x = layer_norm(cross_tokens, w, "norm1", 1e-5)
        lat = layer_norm(hidden, w, "norm2", 1e-5)
        q = self._lin(lat, w, "to_q", bias=False).unflatten(-1, (heads, hd))
        k, v = (t.unflatten(-1, (heads, hd))
                for t in self._lin(x, w, "to_kv", bias=False).chunk(2, dim=-1))
        return self._lin(attention(q, k, v, hd ** -0.5, self.fp8), w, "to_out", bias=False)

    @torch.no_grad()
    def forward(self, latents, text, timestep, inpaint, cross, rope):
        """(B, F, H, W, C) latents -> (B, F, H, W, C) model output (float32)."""
        cfg = self.cfg
        p, dim = cfg["patch_size"], cfg["num_attention_heads"] * cfg["attention_head_dim"]
        b, f, h, wd, _ = latents.shape
        w = self.weights("time_embedding")
        temb = self._lin(F.silu(self._lin(timestep_embedding(timestep, dim), w, "linear_1")),
                         w, "linear_2")
        w = self.weights("patch_embed")
        hidden = patchify(torch.cat([latents, inpaint], dim=-1).float(), w["proj.weight"],
                          w["proj.bias"], p)
        encoder = self._lin(text.float(), w, "text_proj")
        w = self.weights("ref_patch_embed")
        cross_tokens = patchify(cross.float(), w["proj.weight"], w["proj.bias"], p)
        for i in range(cfg["num_layers"]):
            hidden, encoder = self._block(self.weights(f"transformer_blocks.{i}"), hidden,
                                          encoder, temb, rope)
            if i % cfg["cross_attn_interval"] == 0:
                j = i // cfg["cross_attn_interval"]
                hidden = hidden + self._perceiver(
                    self.weights(f"perceiver_cross_attention.{j}"), cross_tokens, hidden)
        tl = encoder.shape[1]
        joint = layer_norm(torch.cat([encoder, hidden], dim=1), self.weights("norm_final"), "",
                           1e-5)
        w = self.weights("norm_out")
        shift, scale = self._lin(F.silu(temb), w, "linear").chunk(2, dim=-1)
        hidden = layer_norm(joint[:, tl:], w, "norm", 1e-5) * (1 + scale[:, None]) \
            + shift[:, None]
        out = self._lin(hidden, self.weights("proj_out"), "")
        c = cfg["out_channels"]
        out = out.reshape(b, f, h // p, wd // p, c, p, p).permute(0, 1, 2, 5, 3, 6, 4)
        return out.reshape(b, f, h, wd, c)
