"""Faults a denoise cell can have, planted in the program for the tests and
for ``tools/calibrate.py``'s readings.  Each takes ``patch(owner, name,
value)``, as pytest's ``monkeypatch.setattr``; ``planted`` undoes its
patches on leaving."""

from __future__ import annotations

import contextlib

import torch


def state_unchanged(patch):
    """The sampler's step returns the latents it was given."""
    from trajectorycrafter_tpu_torch.schedulers.ddim import DDIMScheduler

    patch(DDIMScheduler, "step", lambda self, state, out, i, sample: sample)


def half_batch(patch):
    """The DiT runs the first half of the CFG batch; its mean stands in for the whole."""
    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel

    forward = CrossTransformer3DModel.forward

    def kept_half(self, hidden, text, t, inpaint_latents=None, cross_latents=None, **kw):
        h = hidden.shape[0] // 2
        out = forward(self, hidden[:h], text[:h], t[:h], inpaint_latents[:h],
                      cross_latents[:h], **kw)
        return torch.cat([out.mean(dim=0, keepdim=True)] * hidden.shape[0])

    patch(CrossTransformer3DModel, "forward", kept_half)


def answer_altered(patch):
    """One latent frame of a call's answer is its neighbour's."""
    from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline

    denoise = TrajCrafterPipeline._denoise

    def altered(self, *a, **kw):
        out = denoise(self, *a, **kw).clone()
        out[:, 0] = out[:, 1]
        return out

    patch(TrajCrafterPipeline, "_denoise", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered)}


@contextlib.contextmanager
def planted(name: str):
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
