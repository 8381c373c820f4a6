"""Environment names the ported serving and training paths read.

Own copy of the names the JAX package declares in ``api/constants.py``
(the ``TRAININGJOB_SERVE_*`` knobs, the worker identity and rendezvous the
operator injects, the checkpoint, profiling, telemetry and trace knobs,
the elastic-resize channel); the port
imports nothing of that package, so the names are repeated here verbatim
(tests/test_torch_boundaries.py checks they still agree).
"""

SERVE_SLOTS_ENV = "TRAININGJOB_SERVE_SLOTS"
SERVE_MAX_LEN_ENV = "TRAININGJOB_SERVE_MAX_LEN"
SERVE_PREFILL_CHUNK_ENV = "TRAININGJOB_SERVE_PREFILL_CHUNK"
SERVE_QUEUE_CAP_ENV = "TRAININGJOB_SERVE_QUEUE_CAP"
SERVE_RATE_ENV = "TRAININGJOB_SERVE_RATE"
SERVE_REQUESTS_ENV = "TRAININGJOB_SERVE_REQUESTS"
SERVE_QUANT_ENV = "TRAININGJOB_SERVE_QUANT"

# Worker identity, injected into every container by the operator.
REPLICA_NAME_ENV = "TRAININGJOB_REPLICA_NAME"
REPLICA_INDEX_ENV = "TRAININGJOB_REPLICA_INDEX"
REPLICA_RESTART_COUNT_ENV = "TRAININGJOB_REPLICA_RESTARTCOUNT"
JOB_NAME_ENV = "TRAININGJOB_NAME"
JOB_NAMESPACE_ENV = "TRAININGJOB_NAMESPACE"
ELASTIC_REPLICAS_ENV = "TRAININGJOB_ELASTIC_REPLICAS"
# Set to "1" on re-expand reservation pods (capacity canaries): the worker
# idles instead of joining the rendezvous, and exits 143 past the TTL
# (seconds) so that an orphaned canary frees its host.
RESERVATION_ENV = "TRAININGJOB_RESERVATION"
RESERVATION_TTL_ENV = "TRAININGJOB_RESERVATION_TTL"
# The device a replica group asks for ("cpu", or "gpu"/"cuda" for the
# card): the default of the mains' --device (rendezvous.platform_device).
JAX_PLATFORM_ENV = "TRAININGJOB_JAX_PLATFORM"
# The kernel cache: a job-survivable directory for the built kernel
# library (takes precedence), then the legacy name; "off" in either
# disables it; unset, <checkpoint dir>/.torch_kernel_cache
# (rendezvous.compile_cache_dir).
COMPILE_CACHE_DIR_ENV = "TRAININGJOB_COMPILE_CACHE_DIR"
COMPILE_CACHE_ENV = "TRAININGJOB_COMPILE_CACHE"
# A multi-process job's rendezvous: the coordinator "host:port" the process
# group forms at, the process count and this process's id, and the slice
# (MEGASCALE_*) layout that sets the mesh's dp axis.
COORDINATOR_ADDRESS_ENV = "TRAININGJOB_COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = "TRAININGJOB_NUM_PROCESSES"
PROCESS_ID_ENV = "TRAININGJOB_PROCESS_ID"
SLICE_ID_ENV = "MEGASCALE_SLICE_ID"
NUM_SLICES_ENV = "MEGASCALE_NUM_SLICES"

# The trainer's checkpoint root (workloads/train.py CheckpointState).
CHECKPOINT_DIR_ENV = "TRAININGJOB_CHECKPOINT_DIR"
# "0" turns off the resume fast path: the resume image is not read, and the
# restore and the kernels' warm-up run one after the other.
RESUME_OVERLAP_ENV = "TRAININGJOB_RESUME_OVERLAP"
# "0" turns off snapshot-donate saves: every save writes on the step loop.
CKPT_SNAPSHOT_ENV = "TRAININGJOB_CKPT_SNAPSHOT"
# Checkpoint fault injection: "resume_image" flips a byte of the resume
# image at read; "corrupt_latest" fails the restore of the newest step.
CKPT_FAULT_ENV = "TRAININGJOB_CKPT_FAULT"
# Seconds of waiting for a batch before the prefetcher warns (or, when its
# thread is gone, raises).
PREFETCH_STALL_ENV = "TRAININGJOB_PREFETCH_STALL_S"

# Step profiler: a directory for a torch.profiler Chrome trace of the steps
# "start:stop".
PROFILE_DIR_ENV = "TRAININGJOB_PROFILE_DIR"
PROFILE_STEPS_ENV = "TRAININGJOB_PROFILE_STEPS"
# "1" -> log per-step wall time.
STEP_TIMES_ENV = "TRAININGJOB_STEP_TIMES"
# Device memory is sampled onto every N-th telemetry record; "0" disables.
HBM_SAMPLE_STEPS_ENV = "TRAININGJOB_HBM_SAMPLE_STEPS"

# Telemetry sink "host:port" (one JSON line per step), and the MFU
# accounting overrides.
TELEMETRY_ADDR_ENV = "TRAININGJOB_TELEMETRY_ADDR"
MODEL_FLOPS_ENV = "TRAININGJOB_MODEL_FLOPS_PER_STEP"
PEAK_FLOPS_ENV = "TRAININGJOB_PEAK_FLOPS"

# Trace context "trace_id:span_id" handed down by the launcher (absent: the
# workload tracer is off), and the directory its Chrome trace is written to.
TRACE_CONTEXT_ENV = "TRAININGJOB_TRACE_CONTEXT"
TRACE_DIR_ENV = "TRAININGJOB_TRACE_DIR"
# "1" -> structured JSON log lines.
LOG_JSON_ENV = "TRAININGJOB_LOG_JSON"

# Elastic resize in place (workloads/llama_elastic.py ``resize_cycle``).
# The directory the controller publishes ``generation.json`` into (the
# bumped rendezvous generation, the surviving world, its coordinator), and
# the generation a process was started under: it reacts only to later ones.
RESIZE_DIR_ENV = "TRAININGJOB_RESIZE_DIR"
RENDEZVOUS_GENERATION_ENV = "TRAININGJOB_RENDEZVOUS_GENERATION"
# Seconds between polls of the generation file from the step loop.
RESIZE_POLL_ENV = "TRAININGJOB_RESIZE_POLL_S"
# "0": a published generation checkpoints and exits 143 instead of
# resizing in place.
RESIZE_FASTPATH_ENV = "TRAININGJOB_RESIZE_FASTPATH"
# "0": a multi-process job takes the checkpoint rung at once.
RESIZE_LIVE_ENV = "TRAININGJOB_RESIZE_LIVE"
# Seconds a rank waits for the new generation's coordinator.
RESIZE_BARRIER_ENV = "TRAININGJOB_RESIZE_BARRIER_S"
# Fault injection into the rebootstrap ladder: comma-separated phases
# (shutdown|barrier|reinit|reshard|persist), each optionally ``phase@N``.
RESIZE_FAULT_ENV = "TRAININGJOB_RESIZE_FAULT"
