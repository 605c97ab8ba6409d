"""The port's data pipeline: a copy of ``repro.data``, numpy only."""
