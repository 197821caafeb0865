"""tpugs_torch core math, projection, scene, camera and PLY code against
tpugs on the same numpy inputs (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import PROJ_FIELDS, np_
from tpugs.core import sh as jsh
from tpugs.core import transforms as jtf
from tpugs.core.camera import CameraInfo as JaxCamera
from tpugs.io import ply as jply
from tpugs.ops.projection import project_gaussians as jax_project
from tpugs.utils.synthetic import synthetic_intrinsics as jax_intrinsics
from tpugs.utils.synthetic import synthetic_params as jax_synthetic
from tpugs.viewer.camera import orbit_trajectory as jax_orbit
from tpugs_torch.core import sh as tsh
from tpugs_torch.core import transforms as ttf
from tpugs_torch.core.camera import CameraInfo
from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.io import ply as tply
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                         synthetic_params,
                                         synthetic_params_numpy)
from tpugs_torch.viewer.camera import orbit_trajectory

torch.set_num_threads(1)

N = 257


def _rng_arrays(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return dict(
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.3, (n, 3))).astype(np.float32),
        t_cam=np.concatenate([rng.uniform(-2, 2, (n, 2)),
                              rng.uniform(0.5, 9, (n, 1))], 1).astype(np.float32),
        dirs=rng.normal(size=(n, 3)).astype(np.float32),
        sh=rng.normal(size=(n, 3, 16)).astype(np.float32),
        W=np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
    )


def _t(x):
    return torch.from_numpy(np.array(x))


class TestTransforms:
    def test_quat_to_rotmat(self):
        a = _rng_arrays()
        np.testing.assert_allclose(
            np_(ttf.quat_to_rotmat(_t(a["quats"]))),
            np_(jtf.quat_to_rotmat(jnp.asarray(a["quats"]))), atol=1e-6)

    @pytest.mark.parametrize("modifier", [1.0, 0.5])
    def test_cov3d_matrix_and_components(self, modifier):
        a = _rng_arrays(1)
        np.testing.assert_allclose(
            np_(ttf.compute_cov3d(_t(a["log_scales"]), _t(a["quats"]), modifier)),
            np_(jtf.compute_cov3d(jnp.asarray(a["log_scales"]),
                                  jnp.asarray(a["quats"]), modifier)),
            rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            np_(ttf.cov3d_components(_t(a["log_scales"]), _t(a["quats"]), modifier)),
            np_(jtf.cov3d_components(jnp.asarray(a["log_scales"]),
                                     jnp.asarray(a["quats"]), modifier)),
            rtol=1e-5, atol=1e-7)

    def test_ewa_cov2d_radius_and_inverse(self):
        a = _rng_arrays(2)
        fx, fy = 300.0, 280.0
        got = ttf.ewa_cov2d_scalar(_t(a["log_scales"]), _t(a["quats"]),
                                   _t(a["W"]), _t(a["t_cam"]), fx, fy)
        ref = jtf.ewa_cov2d_scalar(jnp.asarray(a["log_scales"]),
                                   jnp.asarray(a["quats"]), jnp.asarray(a["W"]),
                                   jnp.asarray(a["t_cam"]), fx, fy)
        np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-5, atol=1e-6)
        # The matrix form agrees with the component form on the port's side.
        mat = ttf.compute_cov2d(
            ttf.compute_cov3d(_t(a["log_scales"]), _t(a["quats"])),
            _t(a["W"]), _t(a["t_cam"]), fx, fy)
        np.testing.assert_allclose(np_(mat), np_(got), rtol=1e-4, atol=1e-5)
        # Same covariance in, same radius and conic out.
        np.testing.assert_array_equal(np_(ttf.radius_from_cov2d(_t(np_(ref)))),
                                      np_(jtf.radius_from_cov2d(ref)))
        conic, det = ttf.inv_cov2d(_t(np_(ref)))
        conic_j, det_j = jtf.inv_cov2d(ref)
        np.testing.assert_allclose(np_(conic), np_(conic_j), rtol=1e-6)
        np.testing.assert_allclose(np_(det), np_(det_j), rtol=1e-6)

    def test_perspective_jacobian_and_world_to_camera(self):
        a = _rng_arrays(3)
        np.testing.assert_allclose(
            np_(ttf.perspective_jacobian(_t(a["t_cam"]), 300.0, 280.0)),
            np_(jtf.perspective_jacobian(jnp.asarray(a["t_cam"]), 300.0, 280.0)),
            rtol=1e-6)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = a["W"], [0.1, -0.2, 3.0]
        np.testing.assert_allclose(
            np_(ttf.world_to_camera_points(_t(a["t_cam"]), _t(vm))),
            np_(jtf.world_to_camera_points(jnp.asarray(a["t_cam"]), jnp.asarray(vm))),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_eval(degree):
    a = _rng_arrays(4)
    dirs = a["dirs"] / np.linalg.norm(a["dirs"], axis=1, keepdims=True)
    np.testing.assert_allclose(
        np_(tsh.eval_sh(degree, _t(a["sh"]), _t(dirs))),
        np_(jsh.eval_sh(degree, jnp.asarray(a["sh"]), jnp.asarray(dirs))),
        rtol=1e-5, atol=1e-6)


def _camera_inputs(w, h, seed):
    p = synthetic_params_numpy(300, seed=seed)
    cam = orbit_trajectory(p["means"], 5, w, h)[seed % 5]
    alive = np.random.default_rng(seed).uniform(size=300) > 0.1
    return p, cam.world_to_camera().astype(np.float32), cam.intrinsics_array(), alive


@pytest.mark.parametrize("seed,w,h", [(0, 64, 48), (1, 96, 64)])
@pytest.mark.parametrize("degree", [1, 3])
def test_projection_fields(seed, w, h, degree):
    p, vm, intr, alive = _camera_inputs(w, h, seed)
    args = [p[k] for k in ("means", "quats", "log_scales", "opacity_logits", "sh")]
    got = project_gaussians(*[_t(x) for x in args], _t(alive), _t(vm), _t(intr),
                            w, h, degree)
    ref = jax_project(*[jnp.asarray(x) for x in args], jnp.asarray(alive),
                      jnp.asarray(vm), jnp.asarray(intr), w, h, degree)
    for f in PROJ_FIELDS:
        g, r = np_(getattr(got, f)), np_(getattr(ref, f))
        if g.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=2e-5, atol=1e-5, err_msg=f)
    assert np_(got.visible).sum() > 50


def test_synthetic_scene_matches():
    got = synthetic_params_numpy(100, seed=7, scale_range=(0.002, 0.015))
    ref = jax_synthetic(100, seed=7, scale_range=(0.002, 0.015))
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    tens = synthetic_params(100, seed=7, scale_range=(0.002, 0.015))
    np.testing.assert_array_equal(np_(tens["sh"]), np.asarray(ref["sh"]))
    np.testing.assert_array_equal(synthetic_intrinsics_numpy(96, 64),
                                  np.asarray(jax_intrinsics(96, 64)))


def test_params_from_numpy():
    p = synthetic_params_numpy(10, seed=1)
    t = params_from_numpy(p, "cpu")
    assert set(t) == set(p)
    for k in p:
        assert t[k].dtype == torch.float32 and t[k].device.type == "cpu"
        np.testing.assert_array_equal(np_(t[k]), p[k])


def test_orbit_cameras_match():
    p = synthetic_params_numpy(200, seed=2)
    got = orbit_trajectory(p["means"], 4, 96, 64, elevation_deg=20.0)
    ref = jax_orbit(p["means"], 4, 96, 64, elevation_deg=20.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.world_to_camera(), r.world_to_camera())
        np.testing.assert_array_equal(g.intrinsics_array(), r.intrinsics_array())
        np.testing.assert_array_equal(g.camera_center(), r.camera_center())


def test_camera_info_matches():
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t = rng.normal(size=3)
    kw = dict(image_name="a", width=64, height=48, fx=50.0, fy=51.0, cx=32.0,
              cy=24.0, R=R, t=t)
    got, ref = CameraInfo(**kw), JaxCamera(**kw)
    np.testing.assert_array_equal(got.world_to_camera(), ref.world_to_camera())
    np.testing.assert_array_equal(got.intrinsics_array(), ref.intrinsics_array())


@pytest.mark.parametrize("coeffs", [1, 16])
def test_ply_round_trip_both_ways(tmp_path, coeffs):
    p = synthetic_params_numpy(50, seed=4, sh_coeffs=coeffs)
    args = [p[k] for k in ("means", "sh", "opacity_logits", "log_scales", "quats")]
    tply.write_gaussian_ply_numpy(tmp_path / "t.ply", *args)
    jply.write_gaussian_ply_numpy(tmp_path / "j.ply", *args)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got = tply.read_gaussian_ply(tmp_path / "j.ply")
    ref = jply.read_gaussian_ply(tmp_path / "t.ply")
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], p[k], err_msg=k)
