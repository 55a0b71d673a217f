"""Spherical demo camera path for rendering from a pose.

Counterpart of `jnerf_tpu/dataset/camera_path.py`: an orbit at elevation
-30 deg, radius 4, in NeRF (pre-NGP) world coordinates, as numpy [3,4]
camera-to-world matrices.
"""

from __future__ import annotations

import numpy as np


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world [3,4] at azimuth ``theta_deg``, elevation
    ``phi_deg`` and distance ``radius``, looking at the origin."""
    th = np.radians(theta_deg)
    ph = np.radians(phi_deg)

    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius

    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = np.cos(ph)
    rot_phi[1, 2] = -np.sin(ph)
    rot_phi[2, 1] = np.sin(ph)
    rot_phi[2, 2] = np.cos(ph)

    rot_theta = np.eye(4, dtype=np.float32)
    rot_theta[0, 0] = np.cos(th)
    rot_theta[0, 2] = -np.sin(th)
    rot_theta[2, 0] = np.sin(th)
    rot_theta[2, 2] = np.cos(th)

    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return (flip @ rot_theta @ rot_phi @ trans)[:3, :]


def path_spherical(nframe: int = 80):
    """``nframe`` poses evenly spaced over a full orbit."""
    return [
        pose_spherical(angle, -30.0, 4.0)
        for angle in np.linspace(-180.0, 180.0, nframe + 1)[:-1]
    ]
