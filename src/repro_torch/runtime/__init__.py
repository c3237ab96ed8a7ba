"""Checkpoints and straggler tracking for the training loop."""
