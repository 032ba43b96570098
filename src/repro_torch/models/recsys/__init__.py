"""Recommendation models of the port."""

from . import din

__all__ = ["din"]
