"""Training data for the port: own copy of the JAX package's ``data``."""

from trainingjob_operator_tpu_torch.data.tokens import TokenDataset

__all__ = ["TokenDataset"]
