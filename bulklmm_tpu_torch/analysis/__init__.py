"""Analyses on scan results."""

from .thresholds import Thresholds, get_thresholds, get_thresholds_bulk

__all__ = ["Thresholds", "get_thresholds", "get_thresholds_bulk"]
