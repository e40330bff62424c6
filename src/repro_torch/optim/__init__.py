"""Optimizers and learning-rate schedules (a port of ``repro/optim``)."""
