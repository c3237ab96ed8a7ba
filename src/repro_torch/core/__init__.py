"""Verification core of the port: the dual-environment harness
(``verify``), findings folded into a CI gate (``diagnostics``), and the
reference's HLO transport inspector (``inspector``), copied for the data
types the audit layer reads."""
