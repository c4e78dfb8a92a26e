"""Data pipelines (counterpart of ``repro.data``)."""

from .synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
