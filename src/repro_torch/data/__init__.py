"""The LM data pipeline (a copy of ``repro/data``)."""
