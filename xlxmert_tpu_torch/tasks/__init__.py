"""Training engines."""
