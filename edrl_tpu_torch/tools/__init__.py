"""Measurement and dataset tools of the port, run as scripts (``python -m ...``)."""
