"""What the 124M trainer's first step pays once per process, split by
candidate, on one card.

    python3 -m trainingjob_operator_tpu_torch.workloads.first_step_probe

builds the kernel library (``ops/_build.py``) once, then runs one process
per variant below.  Each imports the package, makes the CUDA context,
loads the library, builds the trainer's step at the 124M config (seq
1024, batch 8, remat "none", ``llama_elastic.make_step_fn`` on a seeded
init) and one token batch, runs its variant's warm-ups (each timed), then
times the first and the second step (each ending in a read of the loss)
and lists the top-level modules the first step imported.

- ``cold``: no warm-up;
- ``imports``: ``import torch.fx.experimental.symbolic_shapes`` (and
  sympy), which the cold first step imports;
- ``kernels``: one forward and backward of the flash kernels and RMSNorm
  on a [1, 128, 12, 64] bf16 input;
- ``cublas_thread``: a bf16 matmul on a helper thread that then ends,
  then one on the main thread (is the handle the helper made reused?);
- ``cublas_main``: the same matmul on the main thread only;
- ``warm_up``: the trainer's warm-up (``train.warm_up``) on a helper
  thread, as ``overlapped_restore`` runs it.

Prints the ``nvidia-smi`` name and power limit, one JSON line per
variant, then a summary line of each variant's first-step seconds.  Needs
one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

VARIANTS = ("cold", "imports", "kernels", "cublas_thread", "cublas_main",
            "warm_up")


def _timed(torch, out: dict, name: str, fn) -> None:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out[name] = time.perf_counter() - t0


def worker(variant: str) -> dict:
    t_start = time.perf_counter()
    import threading

    import torch

    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.ops import _build, flash_attention
    from trainingjob_operator_tpu_torch.ops import rmsnorm
    from trainingjob_operator_tpu_torch.workloads import llama_elastic, train

    out = {"variant": variant, "imports_s": time.perf_counter() - t_start}
    _timed(torch, out, "cuda_init_s",
           lambda: torch.zeros(1, device="cuda"))
    _timed(torch, out, "library_s", _build.library)

    cfg = llama.LlamaConfig.base_124m()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               "cuda", master=True)
    opt_state = train.AdamW(params, 3e-4).state
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step = llama_elastic.make_step_fn(params, cfg, accum=1, lr=3e-4,
                                      remat="none", opt_state=opt_state)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1025),
                           generator=torch.Generator().manual_seed(1)
                           ).to("cuda")
    torch.cuda.synchronize()

    def matmul():
        a = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16)
        (a @ a).sum().item()

    def on_thread(fn):
        th = threading.Thread(target=fn)
        th.start()
        th.join()

    def imports():
        import torch.fx.experimental.symbolic_shapes  # noqa: F401

    def kernels():
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn(1, 128, 12, 64, device="cuda",
                               dtype=torch.bfloat16, generator=g)
                   .requires_grad_() for _ in range(3))
        x = torch.randn(128, 768, device="cuda", dtype=torch.bfloat16,
                        generator=g).requires_grad_()
        scale = torch.ones(768, device="cuda", requires_grad=True)
        y = flash_attention(q, k, v).float().sum() + rmsnorm(x, scale).sum()
        y.backward()

    if variant == "imports":
        _timed(torch, out, "import_s", imports)
    if variant == "kernels":
        _timed(torch, out, "kernels_s", kernels)
    if variant == "cublas_thread":
        _timed(torch, out, "thread_matmul_s", lambda: on_thread(matmul))
        _timed(torch, out, "main_matmul_after_thread_s", matmul)
    if variant == "cublas_main":
        _timed(torch, out, "main_matmul_s", matmul)
    if variant == "warm_up":
        _timed(torch, out, "warm_up_s",
               lambda: on_thread(train.warm_up("cuda")))

    before = set(sys.modules)
    _timed(torch, out, "first_step_s", lambda: float(step(tokens)))
    out["first_step_imported"] = sorted(
        {m.split(".")[0] for m in set(sys.modules) - before})
    out["first_step_imported_n"] = len(set(sys.modules) - before)
    _timed(torch, out, "second_step_s", lambda: float(step(tokens)))
    out["process_to_first_step_s"] = (time.perf_counter() - t_start
                                      - out["second_step_s"])
    return out


def main() -> int:
    if len(sys.argv) > 1:
        print(json.dumps(worker(sys.argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("first_step_probe: CUDA is not available", file=sys.stderr)
        return 2
    from trainingjob_operator_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    _build.build()
    firsts = {}
    for variant in VARIANTS:
        proc = subprocess.run(
            [sys.executable, "-m",
             "trainingjob_operator_tpu_torch.workloads.first_step_probe",
             variant], capture_output=True, text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        firsts[variant] = json.loads(lines[-1])["first_step_s"]
    print(json.dumps({"first_step_s": firsts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
