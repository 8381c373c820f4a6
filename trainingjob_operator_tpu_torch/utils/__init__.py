"""Small shared utilities of the port (own copies of the JAX package's
``utils``)."""
