"""Serving entry points of the PyTorch port: serve and generate."""
