"""Seconds the server spent capturing its decode graph in set-up
(``DecodeServer.capture_s``, summed; none where nothing was captured)."""


def read(run):
    return sum(run.capture_s) if run.capture_s else None
