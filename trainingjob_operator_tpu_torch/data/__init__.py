"""Training data for the port: own copy of the JAX package's ``data``."""

from trainingjob_operator_tpu_torch.data.tokens import (
    TokenDataset,
    write_tokens,
)

__all__ = ["TokenDataset", "write_tokens"]
