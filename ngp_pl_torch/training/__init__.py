"""Checkpoints and metrics; the train step is a later slice."""
