"""The dense language model."""
