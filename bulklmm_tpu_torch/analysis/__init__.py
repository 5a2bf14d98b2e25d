"""Analyses on scan results: thresholds, profile likelihood, FDR."""

from .fdr import bh_adjust, lod_fdr
from .profile_ll import ProfileLL, getLL, profile_LL
from .thresholds import Thresholds, get_thresholds, get_thresholds_bulk

__all__ = [
    "ProfileLL",
    "Thresholds",
    "bh_adjust",
    "getLL",
    "get_thresholds",
    "get_thresholds_bulk",
    "lod_fdr",
    "profile_LL",
]
