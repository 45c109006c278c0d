"""Plain reference of TalkSHOW's assembly of a generated clip
(`smplx_body_pixel.infer_on_audio` + `utils.part2full`): the face's jaw (3)
and expression (100), the body's 129 conv channels, length-matched to the
face, and the canned lower body re-inserted -> (S, T, 265)."""
from __future__ import annotations

import numpy as np
import torch

#: the lower-body pose of a seated speaker (TalkSHOW utils.part2full)
LOWER_POSE = torch.tensor(
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 3.0747, -0.0158, -0.0152,
     -1.1826512813568115, 0.23866955935955048, 0.15146760642528534,
     -1.2604516744613647, -0.3160211145877838, -0.1603458970785141,
     1.1654603481292725, 0.0, 0.0,
     1.2521806955337524, 0.041598282754421234, -0.06312154978513718,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])

#: (source, length) runs of the full 265 channels: "p" from the 232-channel
#: prediction [jaw | conv | expression], "l" from LOWER_POSE
_LAYOUT = (("p", 0, 3), ("l", 0, 15), ("p", 3, 3), ("l", 15, 6), ("p", 6, 3), ("l", 21, 6),
           ("p", 9, 3), ("l", 27, 6), ("p", 12, 220))


def part2full(pred: torch.Tensor) -> torch.Tensor:
    """(..., 232) -> (..., 265)."""
    lp = LOWER_POSE.to(pred.device, pred.dtype).expand(pred.shape[:-1] + (33,))
    return torch.cat([(pred if src == "p" else lp)[..., a:a + n] for src, a, n in _LAYOUT],
                     dim=-1)


def channel_groups() -> dict:
    """Indices of the full 265 channels by what fills them: 'face' (jaw and
    expression), 'body' (the conv channels), 'fixed' (the lower body)."""
    src = part2full(torch.arange(232, dtype=torch.float64)[None])[0]
    marker = part2full(torch.ones(1, 232, dtype=torch.float64) * -7.5)[0]
    fixed = np.nonzero((marker != -7.5).numpy())[0]
    pred = np.nonzero((marker == -7.5).numpy())[0]
    srcs = src.numpy()[pred].astype(int)
    face = pred[(srcs < 3) | (srcs >= 132)]
    body = pred[(srcs >= 3) & (srcs < 132)]
    return {"face": face, "body": body, "fixed": fixed}


def assemble(face: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """face (T, 103), conv (S, Tb, 129) -> (S, T, 265): the body cut or its
    last frame repeated to the face's length."""
    T = face.shape[0]
    S, Tb, _ = conv.shape
    if Tb < T:
        conv = torch.cat([conv, conv[:, -1:].expand(S, T - Tb, -1)], dim=1)
    conv = conv[:, :T]
    pred = torch.cat([face[None, :, :3].expand(S, -1, -1), conv,
                      face[None, :, 3:].expand(S, -1, -1)], dim=-1)
    return part2full(pred)
