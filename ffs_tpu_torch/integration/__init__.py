"""Summation integration: Kabsch classification, backgrounds, corrections."""
