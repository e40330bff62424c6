"""The dense decoder: parameters, layers, model and step functions (a cut
port of ``repro/models``)."""
