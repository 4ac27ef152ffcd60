"""The harness shared by every cell: run loop, traffic, weights,
arithmetic and trace reading."""
