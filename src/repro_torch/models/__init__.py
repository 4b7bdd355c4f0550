"""Models of the port (so far: LeNet-5 for the §VI federation)."""
