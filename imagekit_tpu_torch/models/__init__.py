"""Declarative output-format pipelines (a copy of the reference's)."""
