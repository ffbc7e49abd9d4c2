"""Launchers of the port: the prefill/decode step factories (``steps``) and
the serving CLI (``serve``)."""
