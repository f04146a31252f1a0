"""Runnable examples of the port (``python -m
evolutionary_illusion_generator_tpu_torch.examples.<name>``)."""
