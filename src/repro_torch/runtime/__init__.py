"""The restartable train loop (a port of ``repro/runtime``)."""
