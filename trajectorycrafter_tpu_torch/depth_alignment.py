"""Consistent-depth optimisation: aligning estimated video depth to a reference.

Counterpart of trajectorycrafter_tpu/depth_alignment.py.  Two mechanisms:

* ``align_window``: per-frame (log scale, shift) fitted by Adam so that the
  estimated depth matches a rendered reference where it is known and stays
  temporally smooth (no model in the loop); ``estimate_depth_with_alignment``
  runs it over windows of ``INFER_LEN`` frames sharing ``OVERLAP`` and
  ramp-blends the shared frames.
* ``DepthAlignmentTrainer``: test-time optimisation through a frozen
  Video-Depth-Anything model.  VP mode learns an additive RGB prompt, FT mode
  the model's parameters; each step solves the scale and shift in closed form
  over the whole clip (``compute_scale_and_shift``, the gradient flows
  through it), and the loss is masked L1 + RMSE on inverse depth, a
  scale-shift-invariant term and optionally the geometric TAE
  (``differentiable_tae``).  AdamW as optax's: b1 0.9, b2 0.999, eps 1e-8 and
  weight decay 1e-4 (torch's default is 1e-2); the frozen half gets no
  update and no decay.  With gradients the model recomputes its layers in the
  backward pass (``VideoDepthAnything.checkpoint``): 49 frames at 280x504 hold
  35,329 tokens, whose saved activations would not fit on the card.

The JAX package runs each loop as one jitted ``lax.scan``; here each step is a
forward, ``loss.backward()`` and an optimizer step on the tensors' device.
"""

from __future__ import annotations

import copy
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from trajectorycrafter_tpu_torch.pipelines.depth import window_starts

INFER_LEN = 32
OVERLAP = 10
# optax's adam / adamw defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


class AlignParams(NamedTuple):
    log_scale: torch.Tensor  # (F,) per-frame log scale
    shift: torch.Tensor  # (F,) per-frame shift


def scale_shift_invariant_loss(pred: torch.Tensor, target: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """SSI depth loss in disparity space (MiDaS-style)."""
    eps = 1e-6
    d_p = 1.0 / pred.clamp_min(eps)
    d_t = 1.0 / target.clamp_min(eps)
    w = mask / mask.sum(dim=(-2, -1), keepdim=True).clamp_min(1.0)
    mu_p = (w * d_p).sum(dim=(-2, -1), keepdim=True)
    mu_t = (w * d_t).sum(dim=(-2, -1), keepdim=True)
    s_p = (w * (d_p - mu_p).abs()).sum(dim=(-2, -1), keepdim=True) + eps
    s_t = (w * (d_t - mu_t).abs()).sum(dim=(-2, -1), keepdim=True) + eps
    return (w * ((d_p - mu_p) / s_p - (d_t - mu_t) / s_t).abs()).sum(dim=(-2, -1)).mean()


def temporal_alignment_error(depth: torch.Tensor) -> torch.Tensor:
    """TAE: mean relative frame-to-frame depth change (lower = smoother)."""
    return ((depth[1:] - depth[:-1]).abs() / depth[:-1].clamp_min(1e-6)).mean()


def apply_alignment(depth: torch.Tensor, params: AlignParams) -> torch.Tensor:
    return depth * torch.exp(params.log_scale)[:, None, None] + params.shift[:, None, None]


def align_window(depth: torch.Tensor, ref_depth: torch.Tensor, mask: torch.Tensor,
                 steps: int = 200, lr: float = 0.05, tae_weight: float = 0.1,
                 ssi_weight: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (scale, shift) fitted by ``steps`` Adam steps so that depth
    matches ``ref_depth`` where ``mask`` is set and stays temporally smooth
    -> (aligned depth, the loss of the last step)."""
    f = depth.shape[0]
    params = AlignParams(torch.zeros(f, device=depth.device, requires_grad=True),
                         torch.zeros(f, device=depth.device, requires_grad=True))
    opt = torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    denom = mask.sum().clamp_min(1.0)
    loss = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        aligned = apply_alignment(depth, params)
        loss = (mask * (aligned - ref_depth).abs()).sum() / denom
        loss = loss + tae_weight * temporal_alignment_error(aligned)
        if ssi_weight > 0.0:
            loss = loss + ssi_weight * scale_shift_invariant_loss(aligned, ref_depth, mask)
        loss.backward()
        opt.step()
    with torch.no_grad():
        return apply_alignment(depth, params), loss.detach()


def estimate_depth_with_alignment(depths: np.ndarray, ref_depths: np.ndarray,
                                  ref_masks: np.ndarray, infer_len: int = INFER_LEN,
                                  overlap: int = OVERLAP, steps: int = 200,
                                  device="cpu") -> np.ndarray:
    """``align_window`` over windows of ``infer_len`` frames sharing
    ``overlap``, each shared frame a ramp blend (np.linspace(0, 1, ov + 2)
    without its ends) of the windows that hold it; (F, H, W) host arrays in
    and out, the fits on ``device``."""
    f = depths.shape[0]
    infer_len = min(infer_len, f)
    out = np.zeros_like(depths)
    weight = np.zeros((f, 1, 1), np.float32)
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    prev_start = None
    for s in window_starts(f, infer_len, overlap):
        win = slice(s, s + infer_len)
        aligned, _ = align_window(to_dev(depths[win]), to_dev(ref_depths[win]),
                                  to_dev(ref_masks[win]), steps=steps)
        ov = 0 if prev_start is None else min(max(prev_start + infer_len - s, 0), infer_len)
        ramp = np.ones((infer_len, 1, 1), np.float32)
        if ov > 0:
            ramp[:ov, 0, 0] = np.linspace(0, 1, ov + 2)[1:-1]
        out[win] += aligned.cpu().numpy() * ramp
        weight[win] += ramp
        prev_start = s
    return out / np.maximum(weight, 1e-8)


def compute_scale_and_shift(pred: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form masked least squares (scale, shift), ``scale * pred +
    shift ~ target``, over every axis but the first: (B, ...) -> (B,), (B,);
    (1, 0) where the system is singular."""
    axes = tuple(range(1, pred.ndim))
    m = mask.to(pred.dtype)
    a00 = (m * pred * pred).sum(dim=axes)
    a01 = (m * pred).sum(dim=axes)
    a11 = m.sum(dim=axes)
    b0 = (m * pred * target).sum(dim=axes)
    b1 = (m * target).sum(dim=axes)
    det = a00 * a11 - a01 * a01
    ok = det > 1e-8
    safe = torch.where(ok, det, torch.ones_like(det))
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.ones_like(det))
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, torch.zeros_like(det))
    return scale, shift


def _bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (H, W) at pixel coordinates (u, v), border
    padding (``grid_sample`` align_corners True, padding 'border')."""
    h, w = img.shape
    u = u.clamp(0.0, w - 1.0)
    v = v.clamp(0.0, h - 1.0)
    u0 = torch.floor(u).long().clamp(0, w - 1)
    v0 = torch.floor(v).long().clamp(0, h - 1)
    u1 = (u0 + 1).clamp(0, w - 1)
    v1 = (v0 + 1).clamp(0, h - 1)
    fu = u - u0
    fv = v - v0
    top = img[v0, u0] * (1 - fu) + img[v0, u1] * fu
    bot = img[v1, u0] * (1 - fu) + img[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def differentiable_tae(depth: torch.Tensor, intrinsics: torch.Tensor,
                       extrinsics: torch.Tensor, mask_threshold: float = 1e-3,
                       max_depth: float = 100.0) -> torch.Tensor:
    """Geometric TAE: each frame's depth unprojected, moved into the next
    camera by the relative pose (``extrinsics`` camera-to-world), projected,
    and compared (relative error) with the next frame's depth sampled
    bilinearly there; the mean over the valid pixels of each pair, then over
    the pairs."""
    f, h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    rel = torch.einsum("fij,fjk->fik", torch.linalg.inv(extrinsics[1:]), extrinsics[:-1])
    errs = []
    for d1, d2, t_rel in zip(depth[:-1], depth[1:], rel):
        r, t = t_rel[:3, :3], t_rel[:3, 3]
        pts = torch.stack([(xs - cx) * d1 / fx, (ys - cy) * d1 / fy, d1], dim=-1)
        p2 = torch.einsum("ij,hwj->hwi", r, pts) + t
        z2 = p2[..., 2].clamp_min(1e-6)
        u2 = fx * p2[..., 0] / z2 + cx
        v2 = fy * p2[..., 1] / z2 + cy
        valid = ((d1 > mask_threshold) & (d1 < max_depth) & (u2 >= 0) & (u2 < w)
                 & (v2 >= 0) & (v2 < h) & (p2[..., 2] > mask_threshold))
        sampled = _bilinear_sample(d2, u2, v2)
        err = (p2[..., 2] - sampled).abs() / (sampled + 1e-6)
        m = valid.to(depth.dtype)
        errs.append((err * m).sum() / (m.sum() + 1e-6))
    return torch.stack(errs).mean()


def evaluate_tae(depth: torch.Tensor, intrinsics: torch.Tensor,
                 extrinsics: torch.Tensor) -> float:
    """The TAE taken both ways, averaged."""
    with torch.no_grad():
        fwd = differentiable_tae(depth, intrinsics, extrinsics)
        bwd = differentiable_tae(depth.flip(0), intrinsics, extrinsics.flip(0))
    return float((fwd + bwd) / 2.0)


class DepthAlignmentTrainer:
    """Test-time optimisation through a frozen VDA model: ``mode`` 'VP'
    learns an additive RGB prompt, 'FT' fine-tunes a copy of the model's
    parameters (the model itself is never changed, so every ``train`` starts
    from it, as the JAX trainer starts each call from its parameters).

    After ``train``: ``last_losses`` (the loss before each epoch's update),
    ``last_prompt`` and ``epoch_seconds`` (host seconds of each epoch, ending
    in the loss's fetch to the host).
    """

    def __init__(self, model, lr: float = 2e-3, simple_weight: float = 1.0,
                 ssi_weight: float = 1.0, tae_weight: float = 0.0, mode: str = "VP",
                 depth_scale: float = 10000.0):
        if mode not in ("VP", "FT"):
            raise ValueError(f"mode must be 'VP' or 'FT', got {mode!r}")
        self.model = model.eval().requires_grad_(False)
        self.lr = lr
        self.simple_weight = simple_weight
        self.ssi_weight = ssi_weight
        self.tae_weight = tae_weight
        self.mode = mode
        self.depth_scale = depth_scale
        self.last_losses: Optional[np.ndarray] = None
        self.last_prompt: Optional[torch.Tensor] = None
        self.epoch_seconds: list = []

    def loss(self, depth_inv, sparse_inv, mask, intrinsics=None, extrinsics=None):
        """Masked L1 + RMSE on inverse depth, the SSI term on disparity and,
        with ``tae_weight`` and cameras, the TAE on metric depth
        (``depth_scale / depth_inv``)."""
        m = mask.to(depth_inv.dtype)
        denom = m.sum().clamp_min(1.0)
        diff = depth_inv - sparse_inv
        loss = self.simple_weight * ((m * diff.abs()).sum() / denom
                                     + torch.sqrt((m * diff**2).sum() / denom))
        if self.ssi_weight > 0.0:
            # the SSI helper inverts its inputs: pass depth = 1 / disparity
            loss = loss + self.ssi_weight * scale_shift_invariant_loss(
                1.0 / depth_inv.clamp_min(1e-6), 1.0 / sparse_inv.clamp_min(1e-6), m)
        if self.tae_weight > 0.0 and intrinsics is not None:
            metric = torch.where(depth_inv > 1e-6, self.depth_scale / depth_inv.clamp_min(1e-6),
                                 torch.zeros_like(depth_inv))
            loss = loss + self.tae_weight * differentiable_tae(metric, intrinsics, extrinsics)
        return loss

    @staticmethod
    def predict(model, prompt, frames, sparse, mask):
        """The model on ``frames + prompt`` (F, 3, H, W), fitted to ``sparse``
        on ``mask`` over the whole clip -> (inverse depth, scale, shift); the
        gradient flows through the fit."""
        d = model((frames + prompt)[None])[0]
        scale, shift = compute_scale_and_shift(d.reshape(1, -1), sparse.reshape(1, -1),
                                               mask.reshape(1, -1))
        return d * scale[0] + shift[0], scale[0], shift[0]

    def train(self, frames_im: torch.Tensor, sparse_depth_inv: torch.Tensor,
              sparse_mask: torch.Tensor, intrinsics: Optional[torch.Tensor] = None,
              extrinsics: Optional[torch.Tensor] = None, epochs: int = 50):
        """frames_im (F, 3, H, W) ImageNet-normalised, sparse_depth_inv and
        sparse_mask (F, H, W) on the model's device -> (corrected inverse
        depth (F, H, W), the prompt (F, 3, H, W), scale, shift)."""
        model = self.model
        prompt = torch.zeros_like(frames_im)
        if self.mode == "FT":
            model = copy.deepcopy(self.model).requires_grad_(True)
            trained = list(model.parameters())
        else:
            prompt.requires_grad_(True)
            trained = [prompt]
        opt = torch.optim.AdamW(trained, lr=self.lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                weight_decay=ADAMW_WEIGHT_DECAY)
        model.checkpoint = True
        losses, self.epoch_seconds = [], []
        try:
            for _ in range(epochs):
                t0 = time.perf_counter()
                opt.zero_grad(set_to_none=True)
                d, _, _ = self.predict(model, prompt, frames_im, sparse_depth_inv, sparse_mask)
                loss = self.loss(d, sparse_depth_inv, sparse_mask, intrinsics, extrinsics)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                self.epoch_seconds.append(time.perf_counter() - t0)
        finally:
            model.checkpoint = False
        with torch.no_grad():
            d, scale, shift = self.predict(model, prompt, frames_im, sparse_depth_inv,
                                           sparse_mask)
        self.last_losses = np.asarray(losses, np.float32)
        self.last_prompt = prompt.detach()
        return d, self.last_prompt, float(scale), float(shift)


def align_video_to_pointcloud(frames: torch.Tensor, depths: np.ndarray, intrinsics: torch.Tensor,
                              c2ws: torch.Tensor, points: torch.Tensor, colors: torch.Tensor,
                              steps: int = 200):
    """Render the cloud into each camera, align the estimated depth (F, H, W)
    to the renders, and lift the frames (F, H, W, 3) with the aligned depth
    -> (aligned depths, (new points, new colours)), on the cloud's device."""
    from trajectorycrafter_tpu_torch.geometry.pointcloud import (
        lift_video_to_pointcloud,
        render_zbuffer,
    )

    f, h, w = depths.shape
    renders = [render_zbuffer(points, colors, intrinsics[i], torch.linalg.inv(c2ws[i]), h, w)
               for i in range(f)]
    ref_d = np.stack([r[1].cpu().numpy() for r in renders])
    ref_m = np.stack([r[2].cpu().numpy() for r in renders])
    aligned = estimate_depth_with_alignment(depths, ref_d, ref_m, steps=steps,
                                            device=points.device)
    dev = points.device
    new = lift_video_to_pointcloud(frames.to(dev), torch.from_numpy(aligned).to(dev),
                                   intrinsics.to(dev), c2ws.to(dev))
    return aligned, new
