"""Convert the reference's PyTorch checkpoints into the port's weight files
(the port of scripts/convert_checkpoints.py, which writes orbax trees).

    # a local Hugging Face wav2vec 2.0 snapshot (config.json and
    # pytorch_model.bin or model.safetensors); nothing is downloaded
    python -m talkshow_torch.convert_checkpoints wav2vec \
        --src /path/to/wav2vec2-base-960h --out weights/wav2vec2.pt

    # the reference TalkSHOW trainer's stage checkpoints
    python -m talkshow_torch.convert_checkpoints body_vq --src ckpt-body-vq.pth --out vq.pt
    python -m talkshow_torch.convert_checkpoints body_pixel --src ckpt-pixel.pth \
        --out pixel.pt [--bh_model false]
    python -m talkshow_torch.convert_checkpoints face --src ckpt-face.pth --out face.pt

body_vq, body_pixel and face write `torch.save` files of the port's state
dicts in `Pipeline.load_converted`'s layout ({"vq_body", "vq_hand",
"vq_body_state", "vq_hand_state"}, {"prior", "audio_enc"}, {"face"}; the
VQ states as dicts, as `save_pipeline` writes them), which
`talkshow_torch.pipeline.load_pipeline(path, template)` loads into a
pipeline of the checkpoints' widths.  body_pixel reports the prior's depth,
inferred from its keys (15 for the 3-D prior, 10 for the 6-D one).
wav2vec writes {"wav2vec": the port's Wav2Vec2Encoder state dict,
"config": the Wav2Vec2Config fields}, read without `transformers`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from talkshow_torch import convert
from talkshow_torch.models.wav2vec import Wav2Vec2Encoder

#: safetensors dtype names -> numpy dtypes (BF16 is read as its bits)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> dict:
    """A .safetensors file -> {name: tensor}: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then the
    raw bytes."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        a = np.frombuffer(data[start:end], _ST_DTYPES[info["dtype"]]).reshape(info["shape"])
        t = torch.from_numpy(a.copy())
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def hf_wav2vec(src: str) -> tuple[dict, dict]:
    """A local Hugging Face snapshot directory -> (the port's Wav2Vec2Encoder
    state dict, its config fields).  A CTC snapshot's `wav2vec2.` prefix is
    dropped, and so is every key the encoder does not have (`lm_head`, a
    quantizer), as `Wav2Vec2Model.from_pretrained` drops them."""
    cfg_path = os.path.join(src, "config.json")
    weights = [os.path.join(src, n) for n in ("model.safetensors", "pytorch_model.bin")]
    found = [p for p in weights if os.path.isfile(p)]
    if not os.path.isfile(cfg_path) or not found:
        raise SystemExit(f"no Hugging Face wav2vec 2.0 snapshot at {src}: it needs config.json "
                         f"and model.safetensors or pytorch_model.bin (nothing is downloaded)")
    with open(cfg_path) as f:
        cfg = convert.config_from_hf(json.load(f))
    path = found[0]
    sd = (read_safetensors(path) if path.endswith(".safetensors")
          else torch.load(path, map_location="cpu", weights_only=True))
    if any(k.startswith("wav2vec2.") for k in sd):
        sd = {k[len("wav2vec2."):]: v for k, v in sd.items() if k.startswith("wav2vec2.")}
    want = Wav2Vec2Encoder(cfg).state_dict().keys()
    sd = convert.reference_wav2vec(sd)
    missing = sorted(set(want) - set(sd))
    if missing:
        raise SystemExit(f"{path} lacks {len(missing)} encoder weights, e.g. {missing[:3]}")
    dropped = sorted(set(sd) - set(want))
    if dropped:
        print(f"dropped {len(dropped)} keys the encoder does not have, e.g. {dropped[:3]}")
    return {k: sd[k] for k in want}, dataclasses.asdict(cfg)


def convert_file(kind: str, src: str, bh_model: bool = True) -> dict:
    """The weights file `kind` writes for the checkpoint at `src`."""
    if kind == "wav2vec":
        sd, cfg = hf_wav2vec(src)
        return {"wav2vec": sd, "config": cfg}
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    if kind == "body_vq":
        out = convert.reference_body_vq(ckpt)
        for k in ("vq_body_state", "vq_hand_state"):
            out[k] = out[k]._asdict()
        return out
    if kind == "body_pixel":
        out = convert.reference_body_pixel(ckpt, bh_model)
        print(f"prior: {convert.pixelcnn_depth(out['prior'])} layers, bh_model={bh_model}")
        return out
    return {"face": convert.reference_face(ckpt)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.convert_checkpoints")
    p.add_argument("kind", choices=["wav2vec", "body_vq", "body_pixel", "face"])
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--bh_model", default="true", choices=["true", "false"],
                   help="body_pixel: the prior's Model.bh_model (false: the vertical-only "
                        "prior)")
    args = p.parse_args(argv)
    out = convert_file(args.kind, args.src, args.bh_model == "true")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(out, args.out)
    print(f"saved -> {args.out}")
    return out


if __name__ == "__main__":
    main()
