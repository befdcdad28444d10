"""Optimizers over dicts of tensors."""
