"""The benchmark of the PyTorch and CUDA port (talkshow_torch); see README.md."""
