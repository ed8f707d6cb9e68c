"""Training entry points."""
