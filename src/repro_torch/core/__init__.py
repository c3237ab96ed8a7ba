"""Verification core of the port: the dual-environment harness."""
