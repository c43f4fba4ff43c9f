"""Adapter training in PyTorch: labels and losses, the optimizer and its
schedules, checkpoints and the single-device ``Trainer`` (port of
``magma_tpu/training``)."""
