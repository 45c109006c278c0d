"""nn.Module definitions of the inference path (eval mode)."""
