"""Trajectory synthesis: linear target interpolation and txt-spline mode.

Counterpart of trajectorycrafter_tpu/geometry/trajectory.py.  Knot
interpolation runs on the host in numpy/scipy; poses come from
``sphere2pose`` as (n, 4, 4) float32 tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from scipy.interpolate import UnivariateSpline, interp1d

from trajectorycrafter_tpu_torch.geometry.cameras import sphere2pose


def txt_interpolation(input_list: Sequence[float], n: int, mode: str = "smooth") -> np.ndarray:
    """Resample a knot sequence to n frames: 'smooth' is a cubic smoothing
    spline (scipy's default smoothing factor), 'linear' piecewise linear."""
    x = np.linspace(0, 1, len(input_list))
    if mode == "smooth":
        f = UnivariateSpline(x, input_list, k=3)
    elif mode == "linear":
        f = interp1d(x, input_list)
    else:
        raise KeyError(f"Invalid txt interpolation mode: {mode}")
    return f(np.linspace(0, 1, n))


def _knots_to_frames(values: Sequence[float], frame: int) -> np.ndarray:
    """Spline if >3 knots (endpoints pinned), else linear."""
    values = list(values)
    if len(values) > 3:
        out = txt_interpolation(values, frame, mode="smooth")
        out[0] = values[0]
        out[-1] = values[-1]
        return out
    return txt_interpolation(values, frame, mode="linear")


def generate_traj_specified(c2w_anchor: torch.Tensor, theta: float, phi: float,
                            d_r: float, d_x: float, d_y: float, frame: int) -> torch.Tensor:
    """Linear ramp 0 -> target over ``frame`` poses."""
    ramp = lambda end: np.linspace(0.0, end, frame, dtype=np.float32)
    return sphere2pose(c2w_anchor, ramp(theta), ramp(phi), ramp(d_r), ramp(d_x), ramp(d_y))


def generate_traj_txt(c2w_anchor: torch.Tensor, phi: Sequence[float], theta: Sequence[float],
                      r: Sequence[float], frame: int) -> torch.Tensor:
    """Trajectory from theta/phi/r knot lists (the reference's (phi, theta, r)
    argument order)."""
    return sphere2pose(c2w_anchor, _knots_to_frames(theta, frame),
                       _knots_to_frames(phi, frame), _knots_to_frames(r, frame))


def load_traj_txt(path: str) -> tuple:
    """Parse a 3-line trajectory file: theta / phi / r knot rows."""
    with open(path, "r") as f:
        lines = f.readlines()
    theta = [float(i) for i in lines[0].split()]
    phi = [float(i) for i in lines[1].split()]
    r = [float(i) for i in lines[2].split()]
    return theta, phi, r
