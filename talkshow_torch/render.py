"""Mesh video rendering of generated motion (port of talkshow_tpu/render.py).

The scene is the JAX package's copy of the reference RenderTool
(visualise/rendering.py:94-243, voca/rendering.py:41-177): vertices y/z
flipped, orthographic tiles (800 x 800; `whole_body` 800 x 1440 with
z_offset 1.8; `face` xmag 0.15 and camera y = 1), grid layouts by sequence
count, two-sided smooth Lambert shading of base color (0.3, 0.5, 0.55)
under a point-light rig with 0.2 ambient on white, GT tiles side by side
and captions as the reference's get_sen.

The work is split in three:
- `motion_vertices`: (S, T, 265) parameters -> (S, T, V, 3) vertices through
  the port's SMPL-X LBS (`ops/smplx_lbs.smplx_forward_talkshow`) on the
  model's device, all S * T frames as one batch where `LBS_BYTES` allows;
- `render_frames`: the frame loop, one RGB canvas per frame, each tile from
  the native rasterizer (`native.native_rasterize`, no fallback);
- `write_video`: the cv2 writer and the ffmpeg audio mux.
cv2 is imported only by the writer and the captions, so frames render on a
machine without it.  `_rasterize_numpy` is the plain version of the
rasterizer, kept for the tests.

Needs the licensed SMPLX_NEUTRAL_2020.npz, or any npz in its schema
(`ops/smplx_lbs.build_synthetic_smplx_arrays` writes a synthetic one).
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch

from talkshow_torch import native
from talkshow_torch.ops import smplx_lbs

#: (cols, rows) per sequence count, reference rendering.py:143-163,208-232
GRID_LAYOUTS = {1: (1, 1), 2: (2, 1), 3: (3, 1), 9: (3, 3), 12: (4, 3),
                16: (4, 4), 18: (6, 3)}

#: point-light rig: rows [x, y, z, intensity] (voca/rendering.py:134-152,
#: folded to lambert point lights; spots approximated as points)
LIGHT_RIG = np.array([
    [0.0, -1.0, 1.0, 0.6],
    [0.0, 1.0, 1.0, 0.6],
    [-1.0, 1.0, 2.0, 0.6],
    [-1.0, 2.0, 2.0, 2.0],
    [1.0, 2.0, 2.0, 2.0],
], np.float32)
AMBIENT = 0.2
BASE_COLOR = np.array([0.3, 0.5, 0.55], np.float32)

#: device bytes one LBS batch may take: frames are batched up to this many
#: bytes of their per-vertex transforms (V x 4 x 4 f32 each, with room for
#: the intermediates)
LBS_BYTES = 2 << 30


def camera_for_mode(mode: str):
    """-> (tile_w, tile_h, xmag, ymag, cam_y, cam_z) per reference modes."""
    if mode == "whole_body":           # rendering.py:158-161
        z_off = 1.8
        return 800, 1440, 0.5, 0.5 * z_off, 0.7, 1.0
    if mode == "face":                 # rendering.py:196-198
        return 800, 800, 0.15, 0.15, 1.0, 1.0
    return 800, 800, 0.5, 0.5, 0.7, 1.0


def _rasterize_numpy(verts, faces, xmag, ymag, cam_y, cam_z, lights, ambient,
                     base_color, width, height):
    """The plain numpy version of native ts_rasterize (slow), which the
    tests hold the native rasterizer to; nothing else calls it."""
    V = len(verts)
    vn = np.zeros((V, 3), np.float32)
    tri = verts[faces]                                     # (F, 3, 3)
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True) + 1e-12

    shade = np.full(V, ambient, np.float32)
    for lx, ly, lz, inten in lights:
        d = np.array([lx, ly, lz], np.float32) - verts
        d2 = (d * d).sum(1) + 1e-9
        ndotl = np.abs((vn * d).sum(1)) / np.sqrt(d2)
        shade += inten * ndotl / np.maximum(d2, 1.0)
    shade = np.minimum(shade, 1.0)

    px = (verts[:, 0] / xmag * 0.5 + 0.5) * width
    py = (0.5 - (verts[:, 1] - cam_y) / ymag * 0.5) * height
    pz = cam_z - verts[:, 2]

    img = np.full((height, width, 3), 255, np.uint8)
    zbuf = np.full((height, width), np.inf, np.float32)
    for a, b, c in faces:
        ax, ay, bx, by, cx, cy = px[a], py[a], px[b], py[b], px[c], py[c]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if abs(area) < 1e-9:
            continue
        x0 = max(0, int(np.floor(min(ax, bx, cx))))
        x1 = min(width - 1, int(np.ceil(max(ax, bx, cx))))
        y0 = max(0, int(np.floor(min(ay, by, cy))))
        y1 = min(height - 1, int(np.ceil(max(ay, by, cy))))
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                             np.arange(y0, y1 + 1) + 0.5)
        w0 = ((bx - xs) * (cy - ys) - (by - ys) * (cx - xs)) / area
        w1 = ((cx - xs) * (ay - ys) - (cy - ys) * (ax - xs)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z = w0 * pz[a] + w1 * pz[b] + w2 * pz[c]
        sub_z = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (z > 0.01) & (z < sub_z)
        sub_z[upd] = z[upd]
        s = (w0 * shade[a] + w1 * shade[b] + w2 * shade[c])[upd]
        col = np.clip(s[:, None] * base_color[None], 0, 1) * 255 + 0.5
        img[y0:y1 + 1, x0:x1 + 1][upd] = col.astype(np.uint8)
    return img


def flip_yz(verts: np.ndarray) -> np.ndarray:
    """SMPL-X model space -> the renderer's (rendering.py:136-139)."""
    v = np.asarray(verts, np.float32).copy()
    v[:, 1] = -v[:, 1]
    v[:, 2] = -v[:, 2]
    return v


def render_mesh_frame(verts: np.ndarray, faces: np.ndarray,
                      mode: str = "default") -> np.ndarray:
    """One SMPL-X frame (V, 3) in model space -> shaded RGB uint8 tile, by
    the native rasterizer (the y/z flip is applied here)."""
    w, h, xmag, ymag, cam_y, cam_z = camera_for_mode(mode)
    return native.native_rasterize(flip_yz(verts), np.asarray(faces, np.int32), xmag, ymag,
                                   cam_y, cam_z, LIGHT_RIG, AMBIENT, BASE_COLOR, w, h)


def _labels(n: int, has_gt: bool):
    """Tile captions, reference get_sen (rendering.py:31-64)."""
    if n == 1:
        return ["GT"] if has_gt else ["result"]
    if n == 2 and has_gt:
        return ["GT", "result"]
    out = []
    for i in range(n):
        if i == 0 and has_gt:
            out.append("GT")
        else:
            out.append(f"sample{i}")
    return out


def grid(n: int) -> tuple[int, int]:
    """(cols, rows) of the canvas for n sequences."""
    cols = GRID_LAYOUTS[n][0] if n in GRID_LAYOUTS else int(np.ceil(np.sqrt(n)))
    return cols, -(-n // cols)


@torch.no_grad()
def motion_vertices(model: smplx_lbs.SmplxModel, motion,
                    betas: torch.Tensor | None = None) -> torch.Tensor:
    """(S, T, 265) SMPL-X parameters -> (S, T, V, 3) vertices on the model's
    device, through `smplx_forward_talkshow`: every frame of every sequence
    in one batch, or in batches of as many frames as `LBS_BYTES` holds."""
    dev = model.device
    motion = torch.as_tensor(np.asarray(motion, np.float32), device=dev)
    S, T, C = motion.shape
    if betas is None:
        betas = torch.zeros(model.num_betas, device=dev)
    flat = motion.reshape(S * T, C)
    V = model.v_template.shape[0]
    per = max(1, LBS_BYTES // (V * 4 * 64))
    parts = [smplx_lbs.smplx_forward_talkshow(model, betas, flat[i:i + per])[0]
             for i in range(0, S * T, per)]
    return torch.cat(parts).reshape(S, T, V, 3)


def _caption(tile: np.ndarray, text: str) -> np.ndarray:
    import cv2
    tile = np.ascontiguousarray(tile)
    cv2.putText(tile, text, (100, 100), cv2.FONT_HERSHEY_SIMPLEX, 2, (0, 0, 255), 2,
                cv2.LINE_AA)
    return tile


def render_frames(verts: np.ndarray, faces: np.ndarray, mode: str = "default",
                  labels: list | None = None):
    """(S, T, V, 3) vertices (host) -> one RGB uint8 canvas per frame (a
    generator), the S tiles laid out by `grid`, each captioned when
    `labels` is given."""
    S, T = verts.shape[:2]
    cols, rows = grid(S)
    tw, th = camera_for_mode(mode)[:2]
    faces = np.asarray(faces, np.int32)
    for t in range(T):
        canvas = np.full((th * rows, tw * cols, 3), 255, np.uint8)
        for s in range(S):
            r, c = divmod(s, cols)
            tile = render_mesh_frame(verts[s, t], faces, mode)
            if labels:
                tile = _caption(tile, labels[s])
            canvas[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = tile
        yield canvas


def write_video(frames, out_path: str, fps: int = 30,
                audio_file: str | None = None) -> str:
    """Write RGB canvases as an mp4 with cv2 (BGR, mp4v), then mux the audio
    with ffmpeg when the binary exists (rendering.py:236-241); without it
    the silent video is kept under `out_path`."""
    import cv2

    tmp_video = out_path + ".noaudio.mp4"
    writer = None
    try:
        for canvas in frames:
            if writer is None:
                h, w = canvas.shape[:2]
                writer = cv2.VideoWriter(tmp_video, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                         (w, h))
            writer.write(np.ascontiguousarray(canvas[..., ::-1]))
    finally:
        if writer is not None:
            writer.release()
    if writer is None:
        raise ValueError("no frames to write")
    if audio_file and shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-y", "-i", audio_file, "-i", tmp_video,
               "-c:v", "copy", "-c:a", "aac", "-shortest", out_path]
        if subprocess.run(cmd, capture_output=True).returncode == 0:
            os.remove(tmp_video)
            return out_path
    os.replace(tmp_video, out_path)
    return out_path


def render_motion_video(motion: np.ndarray, audio_file: str | None, out_path: str,
                        smplx_npz: str | None = None, fps: int = 30,
                        mode: str = "default", gt_motion: np.ndarray | None = None,
                        betas: np.ndarray | None = None, add_labels: bool = True,
                        device="cuda") -> str:
    """(S, T, 265) SMPL-X parameters -> shaded-mesh grid video at out_path.

    gt_motion: an optional (T, 265) ground truth rendered as the first tile
    (reference test mode, rendering.py:254-263).  The LBS runs on `device`
    (the card unless the caller asks for the CPU)."""
    if smplx_npz is None or not os.path.isfile(smplx_npz):
        raise FileNotFoundError(
            "rendering needs the SMPL-X model npz (SMPLX_NEUTRAL_2020.npz); "
            "pass smplx_npz=... — it is licensed and not bundled")
    model = smplx_lbs.load_smplx_npz(smplx_npz, device=device)
    if model.faces is None:
        raise ValueError("SMPL-X npz has no face ('f') array")
    motion = np.asarray(motion, np.float32)
    if gt_motion is not None:
        motion = np.concatenate([np.asarray(gt_motion, np.float32)[None], motion], axis=0)
    b = None if betas is None else torch.as_tensor(np.asarray(betas, np.float32),
                                                   device=model.device)
    verts = motion_vertices(model, motion, b).cpu().numpy()
    labels = _labels(len(motion), gt_motion is not None) if add_labels else None
    return write_video(render_frames(verts, model.faces, mode, labels), out_path, fps,
                       audio_file)
