"""Atomic step checkpoints (a port of ``repro/ckpt``)."""
