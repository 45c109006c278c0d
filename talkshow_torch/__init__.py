"""talkshow_torch — the PyTorch / CUDA port of talkshow_tpu.

Speech -> whole-body SMPL-X motion, run eagerly in PyTorch, with the
kernels of the JAX package hand-written in CUDA for Hopper (`csrc/`): the
autoregressive PixelCNN token decode, the wav2vec encoder layers and conv
extractor, and the VQ nearest-code search that training stage 1 runs.

    from talkshow_torch.pipeline import Pipeline
    pipe = Pipeline.create(seed=0, device="cuda")
    motion = pipe.generate("speech.wav", speaker="oliver", num_samples=4)
    # motion: (num_samples, T, 265) SMPL-X params @30fps

    python -m talkshow_torch.train --config_file body_vq.json --synthetic

Module names mirror talkshow_tpu's, so each counterpart is easy to find.
The package imports torch and numpy only: no JAX and nothing of
talkshow_tpu.  Kernels are built with nvcc on first use
(`kernels/_build.py`), so importing the package needs no CUDA toolkit.

Public functions keep the JAX package's channels-last (B, T, C) layout.
"""

__version__ = "0.1.0"
