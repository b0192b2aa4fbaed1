"""The port's geometry and spherical-harmonics functions against the JAX
package's, on the CPU, with inputs made by numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.geometry import projection as jx_geo
from pixelsplat_tpu.model.encoder.common import gaussians as jx_gauss
from pixelsplat_tpu.ops import sh as jx_sh
from pixelsplat_tpu_torch.geometry import projection as pt_geo
from pixelsplat_tpu_torch.model.encoder.common import gaussians as pt_gauss
from pixelsplat_tpu_torch.ops import sh as pt_sh


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.as_tensor(np.array(x))


def random_rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def random_cameras(rng, n):
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    extr[:, :3, :3] = random_rotations(rng, n)
    extr[:, :3, 3] = rng.normal(size=(n, 3))
    intr = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    intr[:, 0, 0] = rng.uniform(0.7, 1.5, n)
    intr[:, 1, 1] = rng.uniform(0.7, 1.5, n)
    intr[:, 0, 2] = rng.uniform(0.4, 0.6, n)
    intr[:, 1, 2] = rng.uniform(0.4, 0.6, n)
    return extr, intr


# Geometry: the same f32 arithmetic in a possibly different order, so a few
# ulps of values of order 1-10.
GEO_TOL = dict(rtol=1e-5, atol=2e-6)


def test_inverse_se3_and_fov():
    rng = np.random.default_rng(0)
    extr, intr = random_cameras(rng, 5)
    np.testing.assert_allclose(
        pt_geo.inverse_se3(t(extr)).numpy(), np.asarray(jx_geo.inverse_se3(jnp.asarray(extr))), **GEO_TOL
    )
    np.testing.assert_allclose(
        pt_geo.get_fov(t(intr)).numpy(), np.asarray(jx_geo.get_fov(jnp.asarray(intr))), **GEO_TOL
    )


def test_get_world_rays_broadcast():
    rng = np.random.default_rng(1)
    extr, intr = random_cameras(rng, 2)
    coords = rng.uniform(0, 1, (2, 7, 1, 2)).astype(np.float32)
    args_j = (jnp.asarray(coords), jnp.asarray(extr)[:, None, None], jnp.asarray(intr)[:, None, None])
    args_p = (t(coords), t(extr)[:, None, None], t(intr)[:, None, None])
    for a, b in zip(jx_geo.get_world_rays(*args_j), pt_geo.get_world_rays(*args_p)):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GEO_TOL)


def test_sample_image_grid():
    xy_j, ij_j = jx_geo.sample_image_grid((5, 7))
    xy_p, ij_p = pt_geo.sample_image_grid((5, 7), device="cpu")
    np.testing.assert_array_equal(xy_p.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(ij_p.numpy(), np.asarray(ij_j))


def test_build_world_covariance_and_quaternions():
    rng = np.random.default_rng(2)
    scales = rng.uniform(0.1, 2.0, (4, 6, 3)).astype(np.float32)
    quats = rng.normal(size=(4, 6, 4)).astype(np.float32)
    c2w = random_rotations(rng, 4)[:, None]
    np.testing.assert_allclose(
        pt_gauss.build_world_covariance(t(scales), t(quats), t(c2w)).numpy(),
        np.asarray(jx_gauss.build_world_covariance(jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(c2w))),
        **GEO_TOL,
    )
    np.testing.assert_allclose(
        pt_gauss.quaternion_to_matrix(t(quats)).numpy(),
        np.asarray(jx_gauss.quaternion_to_matrix(jnp.asarray(quats))),
        **GEO_TOL,
    )


def test_sh_basis_components():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(3, 50)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    got = pt_sh.sh_basis_components(*t(d), 4)
    want = jx_sh.sh_basis_components(*jnp.asarray(d), 4)
    assert len(got) == len(want) == 25
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)


def test_fixed_directions_are_the_same_constants():
    for degree in range(1, 5):
        for a, b in zip(pt_sh._fixed_directions_and_pinv(degree), jx_sh._fixed_directions_and_pinv(degree)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_rotation_matrix(degree):
    rng = np.random.default_rng(10 + degree)
    rots = random_rotations(rng, 6)
    got = pt_sh.sh_rotation_matrix(t(rots), degree).numpy()
    want = np.asarray(jx_sh.sh_rotation_matrix(jnp.asarray(rots), degree))
    # Both run full-f32 contractions (HIGHEST in JAX); entries are O(1).
    np.testing.assert_allclose(got, want, atol=1e-5)
    # And the port's matrices rotate the basis: basis_l(R d) = M basis_l(d).
    d = rng.normal(size=(3,)).astype(np.float32)
    d /= np.linalg.norm(d)
    lo, hi = degree**2, (degree + 1) ** 2
    b_d = np.stack([np.asarray(v) for v in pt_sh.sh_basis_components(*t(d[:, None]), degree)[lo:hi]])[:, 0]
    rd = rots[0] @ d
    b_rd = np.stack([np.asarray(v) for v in pt_sh.sh_basis_components(*t(rd[:, None]), degree)[lo:hi]])[:, 0]
    np.testing.assert_allclose(got[0] @ b_d, b_rd, atol=1e-4)


def test_full_rotation_and_apply_sh_rotation():
    rng = np.random.default_rng(20)
    rots = random_rotations(rng, 2)[:, None, None]  # (2, 1, 1, 3, 3) per camera
    m_j = jx_sh.full_sh_rotation_matrix(jnp.asarray(rots), 4)
    m_p = pt_sh.full_sh_rotation_matrix(t(rots), 4)
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), atol=1e-5)
    sh = rng.normal(size=(2, 9, 1, 3, 25)).astype(np.float32)
    got = pt_sh.apply_sh_rotation(t(sh), m_p[..., None, :, :])
    want = jx_sh.apply_sh_rotation(jnp.asarray(sh), m_j[..., None, :, :])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
