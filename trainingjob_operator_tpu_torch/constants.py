"""Environment names the ported serving and training paths read.

Own copy of the names the JAX package declares in ``api/constants.py``
(the ``TRAININGJOB_SERVE_*`` knobs, the checkpoint root and the per-step
timing switch); the port imports nothing of that package, so the names are
repeated here verbatim (tests/test_torch_boundaries.py checks they still
agree).
"""

SERVE_SLOTS_ENV = "TRAININGJOB_SERVE_SLOTS"
SERVE_MAX_LEN_ENV = "TRAININGJOB_SERVE_MAX_LEN"
SERVE_PREFILL_CHUNK_ENV = "TRAININGJOB_SERVE_PREFILL_CHUNK"
SERVE_QUEUE_CAP_ENV = "TRAININGJOB_SERVE_QUEUE_CAP"
SERVE_RATE_ENV = "TRAININGJOB_SERVE_RATE"
SERVE_REQUESTS_ENV = "TRAININGJOB_SERVE_REQUESTS"
SERVE_QUANT_ENV = "TRAININGJOB_SERVE_QUANT"

# The trainer's checkpoint root; the port refuses it until checkpointing is
# ported (ROADMAP.md queue 1 item 2b).
CHECKPOINT_DIR_ENV = "TRAININGJOB_CHECKPOINT_DIR"
# "1" -> log per-step wall time.
STEP_TIMES_ENV = "TRAININGJOB_STEP_TIMES"
