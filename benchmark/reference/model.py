"""The reference side of a configuration: every module of
`reference/nets.py` built from the configuration file's widths, and the
computations the check replays on the program's outputs."""
from __future__ import annotations

import torch

from benchmark.reference import audio, nets, pose

#: the parts of a TalkSHOW model, by the names the weights carry
PARTS = ("face", "vq_body", "vq_hand", "audio_enc", "prior")


def build(cfg: dict) -> dict:
    """{part: module} at the configuration's widths (on the current default
    device; build under `torch.device("meta")` to only count)."""
    vq, pr, ae = cfg["vq"], cfg["prior"], cfg["audio_encoder"]
    return {
        "face": nets.FaceGenerator(cfg["wav2vec"], cfg["face"]),
        "vq_body": nets.VQVAE(vq["body_channels"], vq["embedding_dim"], vq["num_hiddens"],
                              vq["num_residual_layers"]),
        "vq_hand": nets.VQVAE(vq["hand_channels"], vq["embedding_dim"], vq["num_hiddens"],
                              vq["num_residual_layers"]),
        "audio_enc": nets.AudioEncoder(ae["in_dim"], ae["num_hiddens"]),
        "prior": nets.GatedPixelCNN(pr["input_dim"], pr["dim"], pr["n_layers"], pr["n_classes"],
                                    ae["num_hiddens"], pr["hidden"]),
    }


class Reference:
    """The reference model on `weights` (`benchmark.weights.draw`), eval
    mode, float32 with TF32 off.  `quantize` (a function of a weight
    tensor) puts a lower precision in place: the control."""

    def __init__(self, cfg: dict, weights: dict, device, quantize=None):
        with torch.device("meta"):
            mods = build(cfg)
        self.cfg, self.device = cfg, torch.device(device)
        for name, m in mods.items():
            m.to_empty(device=self.device)
            sd = weights[name]
            if quantize is not None:
                sd = {k: quantize(v) if v.dim() >= 2 else v for k, v in sd.items()}
            m.load_state_dict(sd)
            m.eval()
        self.m = mods
        books = {k: weights[k] for k in ("codebook_body", "codebook_hand")}
        if quantize is not None:
            books = {k: quantize(v) for k, v in books.items()}
        self.books = books

    @torch.no_grad()
    def face(self, wav16k: torch.Tensor) -> torch.Tensor:
        """(N,) 16 kHz -> (N * 30 // 16000, 103), a zero speaker one-hot (the
        demo path of `generate`)."""
        frames = int(wav16k.shape[0] * 30 // 16000)
        onehot = torch.zeros(1, self.cfg["face"]["num_classes"], device=self.device)
        return self.m["face"](wav16k[None], onehot, frames)[0]

    @torch.no_grad()
    def audio(self, wav16k: torch.Tensor) -> torch.Tensor:
        """(N,) -> the audio encoder's (1, H, channels) from the 22 kHz MFCC."""
        return self.m["audio_enc"](audio.get_mfcc(wav16k)[None])

    @torch.no_grad()
    def audio_from_mfcc(self, feat: torch.Tensor) -> torch.Tensor:
        return self.m["audio_enc"](feat[None])

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, speaker: int, aud: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (S, H, 2, K) of the token grids (S, H, 2)."""
        S = tokens.shape[0]
        label = torch.full((S,), speaker, dtype=torch.long, device=self.device)
        return self.m["prior"](tokens, label, aud.expand(S, -1, -1))

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """(S, H, 2) -> conv poses (S, 4 H, body + hand channels)."""
        body = self.m["vq_body"].decode_tokens(self.books["codebook_body"], tokens[..., 0])
        hand = self.m["vq_hand"].decode_tokens(self.books["codebook_hand"], tokens[..., 1])
        return torch.cat([body, hand], dim=-1)

    @staticmethod
    def assemble(face: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
        return pose.assemble(face, conv)
