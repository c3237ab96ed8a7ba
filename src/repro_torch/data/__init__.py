"""Deterministic synthetic token data."""
