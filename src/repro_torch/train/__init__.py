"""Gate-distillation training loop."""
