"""Faults planted in the WavLM face path, for the tests that see `correct`
come out false and for the chip readings that set `face-wavlm-s1`'s limit:

    python -m benchmark.wavlm_faults --fault gate_one --workload face-wavlm-s1 --seeds 1,2,3

plants the fault and runs `benchmark.calibrate` with the other arguments.
Each fault acts on the plain modules (the CPU path) and on the tables K2
is packed from (the card's path):

- ``gate_one``: every layer's gate of the relative bias held at 1;
- ``bias_drop``: the relative bias dropped (the table of zeros)."""
from __future__ import annotations

import sys

import torch


def gate_one_tables(tables: dict) -> dict:
    """K2's pre-norm tables with every layer's gate held at 1."""
    tables["gw"] = torch.zeros_like(tables["gw"])
    # a = sigmoid(+100) = 1, b = sigmoid(-100) ~ 4e-44: a (b c - 1) + 2 = 1
    tables["gbias"] = torch.tensor([100.0, -100.0], device=tables["gbias"].device).expand_as(
        tables["gbias"]).contiguous()
    return tables


def bias_drop_tables(tables: dict) -> dict:
    """K2's pre-norm tables with the relative bias dropped."""
    tables["relb"] = torch.zeros_like(tables["relb"])
    return tables


#: each fault's change of K2's pre-norm tables
TABLE_FAULTS = {"gate_one": gate_one_tables, "bias_drop": bias_drop_tables}


def plant(name: str):
    """Plant fault `name`; returns the function that takes it out."""
    from talkshow_torch.kernels import wav2vec_layers as k2
    from talkshow_torch.models import wav2vec

    undo = []

    def swap(owner, attr, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        undo.append(lambda: setattr(owner, attr, orig))

    if name == "gate_one":
        swap(wav2vec.Attention, "gate",
             lambda orig: lambda self, x: torch.ones_like(orig(self, x)))
        swap(k2, "prenorm_tables", lambda orig: lambda enc: gate_one_tables(orig(enc)))
    elif name == "bias_drop":
        swap(wav2vec.Wav2Vec2Encoder, "position_bias",
             lambda orig: lambda self, T, device: torch.zeros_like(orig(self, T, device)))
        swap(k2, "prenorm_tables", lambda orig: lambda enc: bias_drop_tables(orig(enc)))
    else:
        raise KeyError(f"no WavLM fault {name!r}: gate_one or bias_drop")
    return lambda: [u() for u in reversed(undo)]


def main(argv=None) -> int:
    from benchmark import calibrate
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    plant(name)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
