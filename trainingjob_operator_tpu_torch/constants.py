"""Environment names the ported serving path reads.

Own copy of the ``TRAININGJOB_SERVE_*`` names the JAX package declares in
``api/constants.py``; the port imports nothing of that package, so the
names are repeated here verbatim (tests/test_torch_boundaries.py checks
they still agree).
"""

SERVE_SLOTS_ENV = "TRAININGJOB_SERVE_SLOTS"
SERVE_MAX_LEN_ENV = "TRAININGJOB_SERVE_MAX_LEN"
SERVE_PREFILL_CHUNK_ENV = "TRAININGJOB_SERVE_PREFILL_CHUNK"
SERVE_QUEUE_CAP_ENV = "TRAININGJOB_SERVE_QUEUE_CAP"
SERVE_RATE_ENV = "TRAININGJOB_SERVE_RATE"
SERVE_REQUESTS_ENV = "TRAININGJOB_SERVE_REQUESTS"
SERVE_QUANT_ENV = "TRAININGJOB_SERVE_QUANT"
