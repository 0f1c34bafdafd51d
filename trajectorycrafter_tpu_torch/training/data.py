"""Latent-space training dataset (reference
notebooks/05_11_25_training/lora_utils_ours/dataset_latents.py).

Counterpart of trajectorycrafter_tpu/training/data.py, numpy only: the same
file order, the same ``default_rng`` permutations for the split and the
batches, so both packages read the same samples in the same order.

Samples are pre-encoded .npz files holding channel-last latents:
  gt_latents (F, h, w, C), ref_latents (Fr, h, w, C),
  inpaint_latents (F, h, w, C+1), prompt_embeds (L, D)
(the reference stores the same tensors as torch .pt in b c f h w order).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np


class LatentsDataset:
    def __init__(self, root: str):
        self.root = root
        self.files: List[str] = sorted(
            os.path.join(root, f) for f in os.listdir(root) if f.endswith(".npz")
        )
        if not self.files:
            raise FileNotFoundError(f"no .npz latent samples under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        with np.load(self.files[i]) as z:
            return {k: z[k] for k in z.files}

    def split(self, val_fraction: float, seed: int = 0):
        """Deterministic train/val file split (at least one val sample when
        val_fraction > 0 and the dataset has >= 2 files)."""
        if not 0.0 <= val_fraction < 1.0:
            raise ValueError(f"val_fraction must be in [0, 1), got {val_fraction}")
        n_val = int(round(len(self.files) * val_fraction))
        if val_fraction > 0 and len(self.files) >= 2:
            n_val = max(1, min(n_val, len(self.files) - 1))
        order = np.random.default_rng(seed).permutation(len(self.files))
        train = object.__new__(LatentsDataset)
        val = object.__new__(LatentsDataset)
        train.root = val.root = self.root
        train.files = [self.files[i] for i in sorted(order[n_val:])]
        val.files = [self.files[i] for i in sorted(order[:n_val])]
        return train, val

    def iter_batches(self, batch_size: int, seed: int = 0,
                     epochs: int = -1) -> Iterator[Dict[str, np.ndarray]]:
        if batch_size > len(self.files):
            # every epoch would yield nothing -> the epochs=-1 default would
            # spin forever in next(); fail at construction instead
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{len(self.files)} ({self.root})")
        return self._iter_batches(batch_size, seed, epochs)

    def _iter_batches(self, batch_size: int, seed: int,
                      epochs: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs < 0 or epoch < epochs:
            order = rng.permutation(len(self.files))
            for s in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[int(j)] for j in order[s : s + batch_size]]
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
            epoch += 1


def save_latent_sample(path: str, **arrays: np.ndarray) -> None:
    np.savez_compressed(path, **arrays)
