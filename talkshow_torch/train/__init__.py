"""Training of the port: `python -m talkshow_torch.train` (stage 1, the
body/hand VQ-VAEs), the steps, the trainer and the optimizer wrapper."""
