"""Plain float32 reference of the two training steps the benchmark times
(TalkSHOW `nets/smplx_body_vq.py` and `nets/smplx_body_pixel.py`), on the
modules of `reference/nets.py` in train mode (BatchNorm from the batch's
statistics).

Stage 1, the body and hand VQ-VAEs: encoder -> nearest code (L2) ->
straight-through -> decoder; per part L1 reconstruction + L1 velocity +
0.25 x the commitment MSE, summed; the debiased EMA codebook update
(decay 0.99, Laplace smoothing 1e-5) from the step's codes; Adam (lr 1e-4,
betas 0.9 / 0.999, eps 1e-8).

Stage 2, the prior and the audio encoder on token grids of the frozen
VQ-VAEs (encoder in eval mode -> nearest code): the audio embedding's
dropout given as a keep mask; cross-entropy over the 2048 codes, mean over
every token; the gradients clipped to a global norm of 5; Adam (lr 1e-4).

The conv channels of a pose are TalkSHOW's: the 165 axis-angle channels
without the lower body (129), or their 6-D pairs (258)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import nets

_FIX_3D = set(range(0, 18)) | set(range(21, 27)) | set(range(30, 36)) | set(range(45, 51))
CONV_3D = [i for i in range(165) if i not in _FIX_3D]
CONV_6D = [j for i in CONV_3D for j in (2 * i, 2 * i + 1)]


def conv_channels(poses: torch.Tensor, rep6d: bool) -> torch.Tensor:
    idx = torch.as_tensor(CONV_6D if rep6d else CONV_3D, device=poses.device)
    return poses[..., idx]


def nearest(flat: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    d = (flat * flat).sum(1, keepdim=True) - 2 * flat @ book.t() + (book * book).sum(1)[None]
    return d.argmin(1)


def _load(module, sd, device):
    module.to_empty(device=device)
    module.load_state_dict(sd)
    return module


class Codebook:
    """EMA codebook state of one quantizer."""

    def __init__(self, book: torch.Tensor):
        self.e = book.clone()
        self.dw = torch.zeros_like(book)
        self.count = torch.zeros(book.shape[0], device=book.device)
        self.n = 0

    @torch.no_grad()
    def update(self, flat: torch.Tensor, idx: torch.Tensor, decay=0.99, eps=1e-5):
        K = self.e.shape[0]
        onehot = F.one_hot(idx, K).to(flat.dtype)
        self.n += 1
        self.count = decay * self.count + (1 - decay) * onehot.sum(0)
        self.dw = decay * self.dw + (1 - decay) * (onehot.t() @ flat)
        debias = 1.0 - decay ** self.n
        count, dw = self.count / debias, self.dw / debias
        total = count.sum()
        smoothed = (count + eps) / (total + K * eps) * total
        self.e = dw / smoothed[:, None]


class VQStep:
    """Stage 1 from the weights `w` (benchmark.weights.draw)."""

    def __init__(self, cfg: dict, w: dict, device, rep6d: bool):
        vq = cfg["vq"]
        with torch.device("meta"):
            body = nets.VQVAE(vq["body_channels"], vq["embedding_dim"], vq["num_hiddens"],
                              vq["num_residual_layers"])
            hand = nets.VQVAE(vq["hand_channels"], vq["embedding_dim"], vq["num_hiddens"],
                              vq["num_residual_layers"])
        self.models = {"body": _load(body, w["vq_body"], device).train(),
                       "hand": _load(hand, w["vq_hand"], device).train()}
        self.books = {"body": Codebook(w["codebook_body"]), "hand": Codebook(w["codebook_hand"])}
        self.split = vq["body_channels"]
        self.rep6d = rep6d
        params = [p for m in self.models.values() for p in m.parameters()]
        self.opt = torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)

    def named_parameters(self):
        return [(f"{k}.{n}", p) for k, m in self.models.items() for n, p in m.named_parameters()]

    def loss(self, batch: dict) -> tuple:
        conv = conv_channels(batch["poses"], self.rep6d)
        total, updates = 0.0, []
        for name, x in (("body", conv[..., :self.split]), ("hand", conv[..., self.split:])):
            model, book = self.models[name], self.books[name]
            z = model.encoder(x)
            flat = z.detach().reshape(-1, z.shape[-1])
            idx = nearest(flat, book.e)
            quant = book.e[idx].reshape(z.shape)
            commit = 0.25 * ((z - quant) ** 2).mean()
            recon = model.decoder(z + (quant - z).detach())
            rec = (recon - x).abs().mean()
            vel = (recon.diff(dim=1) - x.diff(dim=1)).abs().mean()
            total = total + rec + vel + commit
            updates.append((book, flat, idx))
        return total, updates

    def step(self, batch: dict) -> float:
        self.opt.zero_grad()
        loss, updates = self.loss(batch)
        loss.backward()
        self.opt.step()
        for book, flat, idx in updates:
            book.update(flat, idx)
        return float(loss.detach())

    def codebooks(self) -> dict:
        return {f"codebook.{k}": b.e for k, b in self.books.items()}


class PixelStep:
    """Stage 2 from the weights `w`: the prior and the audio encoder train;
    the VQ-VAEs' encoders and codebooks are frozen."""

    def __init__(self, cfg: dict, w: dict, device):
        pr, ae = cfg["prior"], cfg["audio_encoder"]
        vq = cfg["vq"]
        with torch.device("meta"):
            prior = nets.GatedPixelCNN(pr["input_dim"], pr["dim"], pr["n_layers"],
                                       pr["n_classes"], ae["num_hiddens"], pr["hidden"])
            audio = nets.AudioEncoder(ae["in_dim"], ae["num_hiddens"])
            body = nets.VQVAE(vq["body_channels"], vq["embedding_dim"], vq["num_hiddens"],
                              vq["num_residual_layers"])
            hand = nets.VQVAE(vq["hand_channels"], vq["embedding_dim"], vq["num_hiddens"],
                              vq["num_residual_layers"])
        self.models = {"prior": _load(prior, w["prior"], device).train(),
                       "audio": _load(audio, w["audio_enc"], device).train()}
        self.frozen = {"body": (_load(body, w["vq_body"], device).eval(), w["codebook_body"]),
                       "hand": (_load(hand, w["vq_hand"], device).eval(), w["codebook_hand"])}
        self.split = vq["body_channels"]
        params = [p for m in self.models.values() for p in m.parameters()]
        self.opt = torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)

    def named_parameters(self):
        return [(f"{k}.{n}", p) for k, m in self.models.items() for n, p in m.named_parameters()]

    @torch.no_grad()
    def tokens(self, poses: torch.Tensor) -> torch.Tensor:
        conv = conv_channels(poses, False)
        out = []
        for name, x in (("body", conv[..., :self.split]), ("hand", conv[..., self.split:])):
            model, book = self.frozen[name]
            z = model.encoder(x)
            out.append(nearest(z.reshape(-1, z.shape[-1]), book).reshape(z.shape[:-1]))
        return torch.stack(out, dim=-1)

    def step(self, batch: dict, tokens: torch.Tensor) -> float:
        self.opt.zero_grad()
        feat = self.models["audio"](batch["aud_feat"])
        logits = self.models["prior"](tokens, batch["speaker"], feat, batch["aud_keep"])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1))
        loss.backward()
        grads = [p.grad for _, p in self.named_parameters()]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm >= 5.0:
            for g in grads:
                g.mul_(5.0 / norm)
        self.opt.step()
        return float(loss.detach())

    def codebooks(self) -> dict:
        return {}
