"""Serving of the port: the multi-table AQP server (``serve.aqp``)."""
