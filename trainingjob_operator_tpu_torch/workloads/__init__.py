"""Entry points of the PyTorch port: serve, generate and the trainer."""
