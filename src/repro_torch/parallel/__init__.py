"""Serving knobs (a cut copy of ``repro/parallel``)."""
