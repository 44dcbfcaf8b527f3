"""Batched caption serving (the port's ``CaptionEngine``)."""

from .engine import CaptionEngine, ServeConfig, ServeStats

__all__ = ["CaptionEngine", "ServeConfig", "ServeStats"]
