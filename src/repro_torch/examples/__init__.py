"""Runnable examples of the port, twins of the JAX package's ``examples/``:
``python -m repro_torch.examples.<name> [--device cpu]`` (quickstart,
serve_sparse, serve_stream, distill_and_eval)."""
