"""Export Gaussians to a 3DGS-viewer-compatible binary PLY file (numpy).

Port of `pixelsplat_tpu/model/ply_export.py`, byte for byte: recentred at
the median Gaussian, rescaled to about [-1, 1], rotated into a
viewer-friendly frame seen from the context camera, the DC colour band
only, binary little-endian float32 written directly. Takes numpy arrays
or tensors on any device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R


def construct_list_of_attributes(num_rest: int) -> list[str]:
    attributes = ["x", "y", "z", "nx", "ny", "nz"]
    attributes += [f"f_dc_{i}" for i in range(3)]
    attributes += [f"f_rest_{i}" for i in range(num_rest)]
    attributes.append("opacity")
    attributes += [f"scale_{i}" for i in range(3)]
    attributes += [f"rot_{i}" for i in range(4)]
    return attributes


def _write_binary_ply(path: Path, names: list[str], data: np.ndarray) -> None:
    """data: (n, len(names)) float32."""
    n = data.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header.append("end_header")
    path.parent.mkdir(exist_ok=True, parents=True)
    with path.open("wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())


def _host(x) -> np.ndarray:
    """A numpy copy of an array or a tensor on any device, in its dtype."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def export_ply(
    extrinsics: np.ndarray,  # (4, 4) context camera
    means: np.ndarray,  # (g, 3)
    scales: np.ndarray,  # (g, 3)
    rotations: np.ndarray,  # (g, 4) xyzw
    harmonics: np.ndarray,  # (g, 3, d_sh)
    opacities: np.ndarray,  # (g,)
    path: Path,
) -> None:
    extrinsics = _host(extrinsics)
    means, scales, rotations, harmonics, opacities = (
        _host(x).astype(np.float32) for x in (means, scales, rotations, harmonics, opacities)
    )

    # Recenter at the median Gaussian, rescale so most fall in [-1, 1].
    means = means - np.median(means, axis=0)
    scale_factor = np.quantile(np.abs(means), 0.95, axis=0).max()
    means = means / scale_factor
    scales = scales / scale_factor

    # +Z up, with a 45-degree viewer adjustment, seen from camera space.
    rotation = np.asarray([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    adjustment = R.from_rotvec([0, 0, -45], True).as_matrix().astype(np.float32)
    rotation = adjustment @ rotation
    rotation = rotation @ np.linalg.inv(np.asarray(extrinsics)[:3, :3])

    means = means @ rotation.T

    rot_mats = R.from_quat(rotations).as_matrix()
    rot_mats = rotation @ rot_mats
    quats_xyzw = R.from_matrix(rot_mats).as_quat()
    # 3DGS .ply stores quaternions wxyz.
    quats_wxyz = np.concatenate(
        [quats_xyzw[:, 3:4], quats_xyzw[:, :3]], axis=-1
    ).astype(np.float32)

    # Only export the DC band (axes are swizzled for higher orders).
    harmonics_dc = harmonics[..., 0]

    data = np.concatenate(
        [
            means,
            np.zeros_like(means),  # normals
            harmonics_dc,
            opacities[:, None],
            np.log(np.maximum(scales, 1e-10)),
            quats_wxyz,
        ],
        axis=1,
    ).astype(np.float32)
    _write_binary_ply(Path(path), construct_list_of_attributes(0), data)
