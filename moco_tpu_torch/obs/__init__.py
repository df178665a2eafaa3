"""Telemetry of the port: the metrics.jsonl schema and its JSONL sink."""
