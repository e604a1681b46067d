"""Observability for the PyTorch port: the span tracer (:mod:`.trace`).

Roofline attribution, export, the metrics registry, time series and the
health watchdogs are still to be ported (ROADMAP queue 1, item 8).
"""
