"""The port's renderer (talkshow_torch/render.py, talkshow_torch/native.py)
against talkshow_tpu/render.py on the CPU.

* the rasterizer's source is a byte-equal copy of native/talkshow_native.cpp;
* the scene constants, camera modes, grid layouts and captions equal JAX's;
* the native rasterizer's frames equal the port's numpy rasterizer
  (`_rasterize_numpy`): at most 0.5 % of the pixels differ by more than 2
  levels (edge pixels where the two sum the barycentric weights in another
  order; the JAX package allows the same in tests/test_render.py);
* the port's frames of a synthetic SMPL-X rig (the vertices from the
  port's LBS) equal `talkshow_tpu.render.render_mesh_frame` on the same
  vertices within that pixel count;
* `motion_vertices` batches every frame (or LBS_BYTES' worth) and equals
  the per-sequence LBS within 1e-5 of max|v| (the same f32 products, whose
  blocking follows the batch size); the frame loop lays out the grid; the writer makes
  an mp4 (cv2 is present here) and a failed rasterization raises."""
import os

import numpy as np
import pytest
import torch

import talkshow_tpu.render as jrender
from talkshow_torch import native, render
from talkshow_torch.ops import smplx_lbs

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(__file__), "..")
#: the largest share of pixels allowed to differ by more than 2 levels
PIXEL_SHARE = 0.005


def _differ(a, b):
    """The share of pixels whose channels differ by more than 2 levels."""
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1) > 2).mean())


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """A synthetic rig in the official npz schema (55 joints, 440 vertices)
    and the vertices of 2 sequences x 3 frames of small random motion."""
    path = str(tmp_path_factory.mktemp("rig") / "rig.npz")
    np.savez(path, **smplx_lbs.build_synthetic_smplx_arrays(verts_per_joint=8))
    model = smplx_lbs.load_smplx_npz(path, device="cpu")
    motion = 0.1 * np.random.default_rng(0).standard_normal((2, 3, 265)).astype(np.float32)
    return path, model, motion, render.motion_vertices(model, motion).numpy()


def test_native_source_is_a_copy():
    with open(os.path.join(REPO, "native", "talkshow_native.cpp"), "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()


def test_scene_equals_jax():
    np.testing.assert_array_equal(render.LIGHT_RIG, jrender.LIGHT_RIG)
    np.testing.assert_array_equal(render.BASE_COLOR, jrender.BASE_COLOR)
    assert render.AMBIENT == jrender.AMBIENT and render.GRID_LAYOUTS == jrender.GRID_LAYOUTS
    for mode in ("default", "whole_body", "face"):
        assert render.camera_for_mode(mode) == jrender.camera_for_mode(mode)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 12])
@pytest.mark.parametrize("has_gt", [False, True])
def test_labels_equal_jax(n, has_gt):
    assert render._labels(n, has_gt) == jrender._labels(n, has_gt)


@pytest.mark.parametrize("mode", ["default", "whole_body"])
def test_native_equals_numpy_rasterizer(rig, mode):
    _, model, _, verts = rig
    w, h, xmag, ymag, cam_y, cam_z = render.camera_for_mode(mode)
    v = render.flip_yz(verts[0, 0])
    # lift the rig into view: the chain's joints rise 0.1 apart from the origin
    v[:, 1] += 1.0
    args = (model.faces, xmag, ymag, cam_y, cam_z, render.LIGHT_RIG, render.AMBIENT,
            render.BASE_COLOR, w, h)
    a = native.native_rasterize(v, *args)
    b = render._rasterize_numpy(v, *args)
    assert a.shape == (h, w, 3) and (a < 255).any(-1).sum() > 1000
    assert _differ(a, b) <= PIXEL_SHARE


def test_frames_equal_jax_render_mesh_frame(rig):
    _, model, _, verts = rig
    for s in range(verts.shape[0]):
        got = render.render_mesh_frame(verts[s, 0], model.faces, "whole_body")
        want = jrender.render_mesh_frame(verts[s, 0], model.faces, "whole_body")
        assert (got < 255).any() and _differ(got, want) <= PIXEL_SHARE


def test_motion_vertices_batch_equals_per_sequence(rig, monkeypatch):
    _, model, motion, verts = rig
    for s in range(motion.shape[0]):
        want, _ = smplx_lbs.smplx_forward_talkshow(model, torch.zeros(model.num_betas),
                                                   torch.as_tensor(motion[s]))
        np.testing.assert_allclose(verts[s], want.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(verts).max())
    # a budget of 2 frames a batch: three batches, the same vertices
    monkeypatch.setattr(render, "LBS_BYTES", 2 * model.v_template.shape[0] * 4 * 64)
    np.testing.assert_allclose(render.motion_vertices(model, motion).numpy(), verts, rtol=0,
                               atol=1e-5 * np.abs(verts).max())


def test_render_frames_lays_out_the_grid(rig):
    _, model, _, verts = rig
    frames = list(render.render_frames(verts, model.faces, "default"))
    assert len(frames) == verts.shape[1]
    assert frames[0].shape == (800, 1600, 3)          # GRID_LAYOUTS[2] = 2 x 1 tiles
    np.testing.assert_array_equal(frames[1][:, 800:],
                                  render.render_mesh_frame(verts[1, 1], model.faces))
    labelled = next(render.render_frames(verts, model.faces, "default", ["GT", "result"]))
    assert not np.array_equal(labelled, frames[0])


def test_render_motion_video_writes_mp4(rig, tmp_path):
    path, _, motion, _ = rig
    out = render.render_motion_video(motion, None, str(tmp_path / "v.mp4"), smplx_npz=path,
                                     mode="whole_body", gt_motion=motion[0], device="cpu")
    assert os.path.isfile(out) and os.path.getsize(out) > 0
    with pytest.raises(FileNotFoundError, match="SMPLX_NEUTRAL_2020"):
        render.render_motion_video(motion, None, str(tmp_path / "w.mp4"), device="cpu")


def test_bad_faces_raise():
    verts = np.zeros((3, 3), np.float32)
    with pytest.raises(RuntimeError, match="out of range"):
        native.native_rasterize(verts, np.array([[0, 1, 7]]), 0.5, 0.5, 0.7, 1.0,
                                render.LIGHT_RIG, render.AMBIENT, render.BASE_COLOR, 8, 8)
