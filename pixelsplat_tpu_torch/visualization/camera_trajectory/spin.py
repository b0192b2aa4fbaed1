"""Orbiting (spin) camera trajectory (host-side numpy).

The port's own copy of `pixelsplat_tpu/visualization/camera_trajectory/spin.py`.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def generate_spin(
    num_frames: int,
    elevation: float,
    radius: float,
) -> np.ndarray:
    tf_translation = np.eye(4, dtype=np.float32)
    tf_translation[:2] *= -1
    tf_translation[2, 3] = -radius

    phi = 2 * np.pi * (np.arange(num_frames) / num_frames)
    rotvecs = np.stack([np.zeros_like(phi), phi, np.zeros_like(phi)], axis=-1)
    azimuth = R.from_rotvec(rotvecs).as_matrix().astype(np.float32)
    tf_azimuth = np.broadcast_to(np.eye(4, dtype=np.float32), (num_frames, 4, 4)).copy()
    tf_azimuth[:, :3, :3] = azimuth

    elev = R.from_rotvec(np.array([np.deg2rad(elevation), 0, 0])).as_matrix()
    tf_elevation = np.eye(4, dtype=np.float32)
    tf_elevation[:3, :3] = elev

    return tf_azimuth @ tf_elevation @ tf_translation
