"""Telemetry: the metrics registry the serving engine writes."""
