"""Numeric foundations: pose layout, audio DSP and codebook lookup."""
