"""Training data: the synthetic packed-sequence stream."""
