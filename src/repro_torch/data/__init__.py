"""Data pipelines: deterministic, restartable synthetic token streams."""
