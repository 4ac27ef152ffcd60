"""Configuration, checkpoint reading and torch->flax name conversion."""
