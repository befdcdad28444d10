"""Sharding over torch.distributed for the serving paths."""
