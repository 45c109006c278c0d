"""The yardstick's arithmetic: the chip's published peaks, the least time a
piece of work can take on it, the AR decode's work worked out from the
prior's widths, and model FLOPs counted over the plain reference.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
`least_s` is the larger of bytes over the HBM rate and operations over the
peak for their type (the arithmetic of the repository's `chip_smoke.py`
`bound`, copied here so that the benchmark owns it)."""
from __future__ import annotations

import functools

import torch

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12

_ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(nbytes: float, flops: float, peak: float = BF16_FLOP_S) -> float:
    """Least seconds the card could take: bytes at the HBM rate or operations
    at `peak`, whichever is longer."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


def ar_decode_macs_per_row(L: int, d: int, K: int, hid: int, A: int) -> int:
    """Multiply-adds of one token row (both columns) of one sample of the
    Gated PixelCNN prior, computed once as an incremental decode does: each
    layer's vertical conv over the 2 real input columns of its 3 taps
    (3 kernel rows at layer 0, 2 after), vert_to_horiz, the horizontal
    taps that read a real column (layer 0: the left one; after: left and
    self), horiz_resid; the fusions' token halves per column and their audio
    halves and the audio embedding once per row; the head per column."""
    vert = 2 * (2 * 3 * d * 2 * d + (L - 1) * 2 * 2 * d * 2 * d)
    v2h = 2 * L * 2 * d * 2 * d
    horiz = (0 + d * 2 * d) + (L - 1) * (d * 2 * d + 2 * d * 2 * d)
    resid = 2 * L * d * d
    fusion = 2 * 2 * d * d + 2 * d * d
    audio = A * d
    head = 2 * (d * hid + hid * K)
    return vert + v2h + horiz + resid + fusion + audio + head


def ar_decode_bytes(L: int, d: int, K: int, hid: int, A: int, H: int, B: int,
                    table_dtype: str, noise_given: bool) -> int:
    """Bytes one decode of B samples over H rows must move: every weight
    the decode reads once at the table type (the vertical convs, v2h, the
    horizontal taps that touch a real column, horiz_resid, both fusions,
    the audio embedding, the head), the embedding rows of the tokens it
    feeds back, the biases and the per-call inputs (audio features, class
    rows) in float32, the gumbel block when it is given, the tokens written
    as int32."""
    e = _ESIZE[table_dtype]
    weights = (2 * d * d * 3 * 3 + (L - 1) * 2 * d * d * 2 * 3      # vert_stack
               + L * 2 * d * 2 * d                                 # vert_to_horiz
               + 2 * d * d + (L - 1) * 2 * d * d * 2               # horiz_stack
               + L * d * d                                         # horiz_resid
               + 2 * (2 * d * d)                                   # fusion_v, fusion_h
               + A * d + d * hid + hid * K)                        # audio embedding, head
    emb_rows = min(K, 2 * B * H) * d
    biases = L * (2 * d + 2 * d + 2 * d + d) + 2 * d + d + hid + K
    inputs = B * H * A + L * B * 2 * d + (H * 2 * B * K if noise_given else 0)
    return e * (weights + emb_rows) + 4 * (biases + inputs) + 4 * B * H * 2


def ar_decode_least_s(prior: dict, A: int, H: int, B: int, table_dtype: str,
                      noise_given: bool) -> float:
    """Least seconds of one decode on the card (bf16 tensor-core peak)."""
    L, d, K, hid = prior["n_layers"], prior["dim"], prior["input_dim"], prior["hidden"]
    flops = 2.0 * B * H * ar_decode_macs_per_row(L, d, K, hid, A)
    nbytes = ar_decode_bytes(L, d, K, hid, A, H, B, table_dtype, noise_given)
    return least_s(nbytes, flops)


def _json_key(cfg: dict) -> str:
    import json
    return json.dumps(cfg, sort_keys=True)


@functools.lru_cache(maxsize=64)
def _generate_flops(cfg_key: str, samples: int, wav_len: int, feat_frames: int,
                    with_face: bool) -> float:
    import json

    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import model as ref_model
    cfg = json.loads(cfg_key)
    with torch.device("meta"):
        m = ref_model.build(cfg)
        H = feat_frames // 4
        emb = cfg["vq"]["embedding_dim"]
        with FlopCounterMode(display=False) as fc:
            if with_face:
                frames = wav_len * 30 // 16000
                m["face"](torch.empty(1, wav_len), torch.empty(1, cfg["face"]["num_classes"]),
                          frames)
            m["audio_enc"](torch.empty(samples, feat_frames, cfg["audio_encoder"]["in_dim"]))
            m["vq_body"].decoder(torch.empty(samples, H, emb))
            m["vq_hand"].decoder(torch.empty(samples, H, emb))
    pr, A = cfg["prior"], cfg["audio_encoder"]["num_hiddens"]
    decode = 2.0 * samples * H * ar_decode_macs_per_row(pr["n_layers"], pr["dim"],
                                                        pr["input_dim"], pr["hidden"], A)
    return float(fc.get_total_flops()) + decode


def generate_flops(cfg: dict, samples: int, wav_len: int, feat_frames: int,
                   with_face: bool = True) -> float:
    """Model FLOPs of one request: the face stage on `wav_len` samples (when
    the entry runs it), the audio encoder and both VQ decoders at the
    request's batch, counted by FlopCounterMode over the reference on meta
    tensors, and the AR decode by `ar_decode_macs_per_row`."""
    return _generate_flops(_json_key(cfg), samples, wav_len, feat_frames, with_face)


def mfcc_frames(wav_len_16k: int, sr: int = 22000, hop: int = 734) -> int:
    """MFCC frames of a 16 kHz clip resampled to `sr` (centred frames)."""
    return -(-sr * wav_len_16k // 16000) // hop + 1


@functools.lru_cache(maxsize=16)
def _train_flops(cfg_key: str, driver: str, batch: int, window: int, rep6d: bool) -> float:
    import json

    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import nets
    from benchmark.reference import train as ref_train
    cfg = json.loads(cfg_key)
    vq, pr, ae = cfg["vq"], cfg["prior"], cfg["audio_encoder"]
    with torch.device("meta"):
        if driver == "train_vq":
            mods = [nets.VQVAE(vq[f"{p}_channels"], vq["embedding_dim"], vq["num_hiddens"],
                               vq["num_residual_layers"]) for p in ("body", "hand")]
            books = [torch.empty(vq["code_num"], vq["embedding_dim"]) for _ in mods]
            poses = torch.empty(batch, window, 330 if rep6d else 165)
            with FlopCounterMode(display=False) as fc:
                conv = ref_train.conv_channels(poses, rep6d)
                xs = (conv[..., :vq["body_channels"]], conv[..., vq["body_channels"]:])
                loss = 0.0
                for m, book, x in zip(mods, books, xs):
                    z = m.encoder(x)
                    flat = z.reshape(-1, z.shape[-1])
                    idx = ref_train.nearest(flat, book)
                    quant = book[idx].reshape(z.shape)
                    loss = loss + (m.decoder(z + (quant - z)) - x).abs().mean()
                    torch.nn.functional.one_hot(idx, book.shape[0]).float().t() @ flat
                loss.backward()
        else:
            prior = nets.GatedPixelCNN(pr["input_dim"], pr["dim"], pr["n_layers"],
                                       pr["n_classes"], ae["num_hiddens"], pr["hidden"])
            audio = nets.AudioEncoder(ae["in_dim"], ae["num_hiddens"])
            H = window // 4
            with FlopCounterMode(display=False) as fc:
                feat = audio(torch.empty(batch, window, ae["in_dim"]))
                tokens = torch.zeros(batch, H, 2, dtype=torch.long)
                logits = prior(tokens, torch.zeros(batch, dtype=torch.long), feat)
                loss = torch.nn.functional.cross_entropy(logits.reshape(-1, pr["input_dim"]),
                                                         tokens.reshape(-1))
                loss.backward()
    return float(fc.get_total_flops())


def train_flops(cfg: dict, workload: dict) -> float:
    """Model FLOPs of one training step at the cell's batch and window:
    forward and backward of the reference on meta tensors (FlopCounterMode),
    with stage 1's nearest-code products and EMA sums."""
    return _train_flops(_json_key(cfg), workload["driver"], workload["batch"],
                        workload["window"], bool(workload.get("rep6d", False)))
