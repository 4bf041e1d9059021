"""Rotating-camera-rig pan compensation, the counterpart of
acinoset_tpu.utils.pan_compensation (src/pan_compensation.py twin).

The AcinoSet rotating rig logs an encoder count per frame; points
reconstructed in the rotating frame are de-rotated about the z axis.
Encoder scale: 102000 counts per revolution (src/pan_compensation.py:29).
On tensors, over any leading dimensions.
"""
from __future__ import annotations

import math

import torch

COUNTS_PER_REV = 102000.0


def count_to_rad(encoder_count):
    """Encoder counts -> radians (src/pan_compensation.py:25-29), in
    float64 unless given a floating-point tensor."""
    counts = torch.as_tensor(encoder_count)
    if not (torch.is_tensor(encoder_count) and counts.is_floating_point()):
        counts = counts.to(torch.float64)
    return counts * (2.0 * math.pi / COUNTS_PER_REV)


def rotate_point(points, theta):
    """Rotate points (..., 3) about the z axis by theta (a scalar or
    broadcastable (...,)): the Euler-Rodrigues rotation of
    src/pan_compensation.py:4-23."""
    points = torch.as_tensor(points)
    theta = torch.as_tensor(theta, dtype=points.dtype, device=points.device)
    c, s = torch.cos(theta), torch.sin(theta)
    x = c * points[..., 0] - s * points[..., 1]
    y = s * points[..., 0] + c * points[..., 1]
    return torch.stack([x, y, points[..., 2].expand_as(x)], dim=-1)
