"""Plain fp32 PyTorch references: they import nothing of the program."""
