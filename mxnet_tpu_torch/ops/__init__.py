"""Tensor-level ops of the port (torch tensors in, torch tensors out)."""
