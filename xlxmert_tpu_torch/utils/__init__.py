"""Small helpers: grid boxes, device selection."""
