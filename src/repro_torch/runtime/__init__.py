"""Checkpoints, straggler tracking and failure detection (``health``) for
the training loop."""
