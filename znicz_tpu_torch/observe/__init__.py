"""Telemetry: the metrics registry (:mod:`.metrics`), host spans and
request traces (:mod:`.tracing`) and the ops flight recorder
(:mod:`.recorder`)."""
