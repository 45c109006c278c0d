"""The port's geometry (talkshow_torch/ops/rotation.py, ops/pose.py,
ops/smplx_lbs.py) against the JAX modules on the CPU, in f32.

Tolerances: rotations within 1e-5 where the value is O(1) (the same f32
formulas; atan2 / sqrt / sin may round differently in the last bit), on
random, near-zero (1e-7 .. 1e-5 rad, the Taylor branch) and near-pi
angles; axis-angle outputs near pi within 1e-4 (the inverse's condition
number there is ~1/|pi - angle| and float32 quaternions hold pi - angle
only to ~1e-7 / |sin|).  The pose converters copy or slice, so they are
equal exactly, the 6-D converters within 1e-5.  The hand-PCA asset is the
JAX package's byte for byte.  LBS on the `verts_per_joint=4` chain rig of
tests/test_smplx_lbs.py: joints and vertices within 1e-5 of JAX's."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.ops import pose as jpose
from talkshow_tpu.ops import rotation as jrot
from talkshow_tpu.ops import smplx_lbs as jlbs
from talkshow_torch.ops import pose as tpose
from talkshow_torch.ops import rotation as trot
from talkshow_torch.ops import smplx_lbs as tlbs

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _aa(kind, n=256, seed=0):
    """(n, 3) f32 axis-angles: random, near zero, or near pi."""
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    if kind == "random":
        ang = rng.uniform(0.0, 3.0, (n, 1))
    elif kind == "small":
        ang = 10.0 ** rng.uniform(-7, -5, (n, 1))
    else:
        ang = np.pi - 10.0 ** rng.uniform(-4, -2, (n, 1))
    return (axis * ang).astype(np.float32)


def _j(fn, *a, **kw):
    return np.asarray(fn(*(jnp.asarray(x) for x in a), **kw))


def _t(fn, *a, **kw):
    return fn(*(torch.as_tensor(np.array(x)) for x in a), **kw).numpy()


@pytest.mark.parametrize("kind", ["random", "small", "near_pi"])
def test_rotation_conversions_match_jax(kind):
    aa = _aa(kind)
    m = _j(jrot.axis_angle_to_matrix, aa)
    np.testing.assert_allclose(_t(trot.axis_angle_to_matrix, aa), m, atol=TOL)
    q = _j(jrot.axis_angle_to_quaternion, aa)
    np.testing.assert_allclose(_t(trot.axis_angle_to_quaternion, aa), q, atol=TOL)
    np.testing.assert_allclose(_t(trot.quaternion_to_matrix, q), _j(jrot.quaternion_to_matrix, q),
                               atol=TOL)
    np.testing.assert_allclose(_t(trot.matrix_to_quaternion, m), _j(jrot.matrix_to_quaternion, m),
                               atol=TOL)
    back_tol = 1e-4 if kind == "near_pi" else TOL
    np.testing.assert_allclose(_t(trot.matrix_to_axis_angle, m), _j(jrot.matrix_to_axis_angle, m),
                               atol=back_tol)
    np.testing.assert_allclose(_t(trot.quaternion_to_axis_angle, q),
                               _j(jrot.quaternion_to_axis_angle, q), atol=back_tol)
    d6 = _j(jrot.axis_angle_to_rotation_6d, aa)
    np.testing.assert_allclose(_t(trot.axis_angle_to_rotation_6d, aa), d6, atol=TOL)
    np.testing.assert_allclose(_t(trot.rotation_6d_to_matrix, d6), _j(jrot.rotation_6d_to_matrix, d6),
                               atol=TOL)
    np.testing.assert_allclose(_t(trot.rotation_6d_to_axis_angle, d6),
                               _j(jrot.rotation_6d_to_axis_angle, d6), atol=back_tol)
    assert np.isfinite(_t(trot.matrix_to_axis_angle, m)).all()


def test_matrix_to_quaternion_tie_breaks_to_the_first_candidate():
    """Identity and 180-degree turns give equal candidate denominators;
    the one-hot keeps the first, as jnp.argmax."""
    m = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, -1.0, 1.0]),
                  np.diag([-1.0, 1.0, -1.0])]).astype(np.float32)
    np.testing.assert_array_equal(_t(trot.matrix_to_quaternion, m),
                                  _j(jrot.matrix_to_quaternion, m))


def test_rotation_6d_round_trip():
    aa = _aa("random", seed=1)
    m = _t(trot.axis_angle_to_matrix, aa)
    np.testing.assert_allclose(_t(trot.rotation_6d_to_matrix, _t(trot.matrix_to_rotation_6d, m)),
                               m, atol=TOL)
    np.testing.assert_allclose(_t(trot.rotation_6d_to_axis_angle,
                                  _t(trot.axis_angle_to_rotation_6d, aa)), aa, atol=1e-4)


def test_quaternion_algebra_and_euler_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((64, 4)).astype(np.float32)
    b = rng.standard_normal((64, 4)).astype(np.float32)
    p = rng.standard_normal((64, 3)).astype(np.float32)
    for name in ("quaternion_raw_multiply", "quaternion_multiply"):
        np.testing.assert_allclose(_t(getattr(trot, name), a, b), _j(getattr(jrot, name), a, b),
                                   atol=TOL, err_msg=name)
    for name in ("standardize_quaternion", "quaternion_invert"):
        np.testing.assert_array_equal(_t(getattr(trot, name), a), _j(getattr(jrot, name), a))
    qn = a / np.linalg.norm(a, axis=-1, keepdims=True)
    np.testing.assert_allclose(_t(trot.quaternion_apply, qn, p), _j(jrot.quaternion_apply, qn, p),
                               atol=TOL)
    ang = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    for conv in ("XYZ", "ZYX", "XZX", "YXY"):
        m = _j(jrot.euler_angles_to_matrix, ang, convention=conv)
        np.testing.assert_allclose(_t(trot.euler_angles_to_matrix, ang, convention=conv), m,
                                   atol=TOL, err_msg=conv)
        np.testing.assert_allclose(_t(trot.matrix_to_euler_angles, m, convention=conv),
                                   _j(jrot.matrix_to_euler_angles, m, convention=conv),
                                   atol=1e-4, err_msg=conv)


def test_hand_asset_is_the_jax_copy_and_pca_matches():
    here = os.path.join(REPO, "talkshow_torch", "assets", "hand_component.json")
    there = os.path.join(REPO, "talkshow_tpu", "assets", "hand_component.json")
    assert open(here, "rb").read() == open(there, "rb").read()
    tpose.load_hand_components.cache_clear()
    for a, b in zip(tpose.load_hand_components(), jpose.load_hand_components()):
        np.testing.assert_array_equal(a, b)
    packed = np.random.default_rng(3).standard_normal((20, 99)).astype(np.float32)
    np.testing.assert_array_equal(tpose.hand_pca_to_full(packed), jpose.hand_pca_to_full(packed))


def test_hand_components_follow_talkshow_assets(tmp_path, monkeypatch):
    left = np.eye(45) * 2.0
    (tmp_path / "hand_component.json").write_text(
        '{"left": %s, "right": %s}' % (left.tolist(), np.eye(45).tolist()))
    monkeypatch.setenv("TALKSHOW_ASSETS", str(tmp_path))
    tpose.load_hand_components.cache_clear()
    try:
        np.testing.assert_array_equal(tpose.load_hand_components()[0], left)
    finally:
        tpose.load_hand_components.cache_clear()


def test_pose_converters_match_jax():
    rng = np.random.default_rng(4)
    full = rng.standard_normal((12, 265)).astype(np.float32)
    pred = rng.standard_normal((12, 232)).astype(np.float32)
    gt = rng.standard_normal((12, 265)).astype(np.float32)
    for stand in (False, True):
        np.testing.assert_array_equal(_t(tpose.poses2pred, full, stand=stand),
                                      _j(jpose.poses2pred, full, stand=stand))
    np.testing.assert_array_equal(_t(tpose.pred2poses, pred, gt), _j(jpose.pred2poses, pred, gt))
    np.testing.assert_array_equal(_t(tpose.poses2poses, full, gt), _j(jpose.poses2poses, full, gt))
    for rep6d, width in ((False, 165), (True, 330)):
        x = rng.standard_normal((5, width)).astype(np.float32)
        np.testing.assert_array_equal(_t(tpose.full_to_conv, x, rep6d=rep6d),
                                      _j(jpose.full_to_conv, x, rep6d=rep6d))
    jaw, exp = tpose.split_jaw_body_exp(torch.as_tensor(full[:, :103]))
    assert jaw.shape == (12, 3) and exp.shape == (12, 100)
    poses = (0.8 * rng.standard_normal((9, 165))).astype(np.float32)
    d6 = _j(jpose.axis_angle_poses_to_6d, poses)
    np.testing.assert_allclose(_t(tpose.axis_angle_poses_to_6d, poses), d6, atol=TOL)
    np.testing.assert_allclose(_t(tpose.pose6d_to_axis_angle, d6),
                               _j(jpose.pose6d_to_axis_angle, d6), atol=TOL)
    five = rng.standard_normal((7, 375)).astype(np.float32)
    for expression, x in ((True, five), (False, five[:, :275])):
        np.testing.assert_allclose(_t(tpose.pose5d_to_axis_angle, x, expression=expression),
                                   _j(jpose.pose5d_to_axis_angle, x, expression=expression),
                                   atol=TOL)


# ---------------------------------------------------------------------------
# SMPL-X LBS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The 4-vertex-per-joint rig in the official schema, written to an npz
    and loaded by both packages."""
    path = str(tmp_path_factory.mktemp("smplx") / "rig.npz")
    np.savez(path, **tlbs.build_synthetic_smplx_arrays(verts_per_joint=4, seed=0))
    return jlbs.load_smplx_npz(path), tlbs.load_smplx_npz(path, device="cpu")


def test_rig_builder_equals_the_script_and_sizes_the_official_mesh():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_smplx", os.path.join(REPO, "scripts", "make_synthetic_smplx.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    for vpj in (4, 8):
        want = mk.build_synthetic_smplx_arrays(vpj, seed=1)
        for got in (tlbs.build_synthetic_smplx_arrays(vpj, seed=1),
                    tlbs.build_synthetic_smplx_arrays(seed=1, num_verts=55 * vpj)):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    big = tlbs.build_synthetic_smplx_arrays(seed=0, num_verts=tlbs.NUM_VERTS)
    assert big["v_template"].shape == (10475, 3) and big["shapedirs"].shape == (10475, 3, 400)
    assert big["posedirs"].shape == (10475, 3, 486) and big["weights"].shape == (10475, 55)
    np.testing.assert_allclose(big["J_regressor"].sum(1), 1.0)
    np.testing.assert_allclose(big["weights"].sum(1), 1.0)


def test_load_smplx_npz_matches_jax(rig):
    jm, tm = rig
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
              "hands_mean_l", "hands_mean_r"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), f)
    np.testing.assert_array_equal(tm.parents, jm.parents)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    assert (tm.num_betas, tm.num_expression) == (300, 100)


@pytest.mark.parametrize("return_verts", [True, False], ids=["verts", "joints"])
def test_smplx_forward_matches_jax(rig, return_verts):
    jm, tm = rig
    rng = np.random.default_rng(5)
    pred = (0.4 * rng.standard_normal((6, 265))).astype(np.float32)
    betas = rng.standard_normal(300).astype(np.float32)
    jv, jj = jlbs.smplx_forward_talkshow(jm, jnp.asarray(betas), jnp.asarray(pred),
                                         return_verts=return_verts)
    tv, tj = tlbs.smplx_forward_talkshow(tm, torch.as_tensor(betas), torch.as_tensor(pred),
                                         return_verts=return_verts)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=TOL)
    if return_verts:
        assert tv.shape == (6, 220, 3)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    else:
        assert tv is None and jv is None


def test_batch_rigid_transform_ignores_the_root_parent(rig):
    """The official kintree's root entry is 2**32 - 1: only parents[1:] is read."""
    _, tm = rig
    rng = np.random.default_rng(6)
    rots = trot.axis_angle_to_matrix(torch.as_tensor(0.3 * rng.standard_normal((2, 55, 3)),
                                                     dtype=torch.float32))
    joints = torch.as_tensor(rng.standard_normal((2, 55, 3)), dtype=torch.float32)
    odd = tm.parents.copy()
    odd[0] = 2 ** 32 - 1
    for a, b in zip(tlbs.batch_rigid_transform(rots, joints, tm.parents),
                    tlbs.batch_rigid_transform(rots, joints, odd)):
        assert torch.equal(a, b)


def test_geometry_modules_import_no_jax():
    code = ("import sys, talkshow_torch.ops.rotation, talkshow_torch.ops.pose, "
            "talkshow_torch.ops.smplx_lbs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'talkshow_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
