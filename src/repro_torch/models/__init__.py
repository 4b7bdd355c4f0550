"""Models of the port: LeNet-5 for the §VI federation, and the LM zoo's
attention-only transformers (``transformer``) for serving."""
