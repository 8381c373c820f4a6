"""Serving plane: open-loop request queue + continuous-batching decode.

Port of the JAX package's ``workloads/serve.py``.  One fixed-shape batched
decode step (``serve_step``) runs every scheduler tick over a slot map; a
prompt prefills in fixed-size chunks (``prefill_chunk``, one slot per tick)
interleaved with decode; admission zeroes the slot's K/V
(``decode.reset_slot``) and survivors are never re-prefilled.  The model
family picks the module: ``models/decode.py`` for Llama,
``models/moe_decode.py`` for MoE, whose cache has the same layout and so
the same ``decode.reset_slot`` (the JAX service looks for a
``moe_decode.reset_slot`` that does not exist, and fails to start).  The
admission queue is bounded (``QueueFull``).  ``policy="static"`` is the
gang-batching baseline: admit only into an all-free batch.

Decoding is greedy: the argmax stays on the device and each decode tick
copies one [slots] vector of picks to the host.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.serve
[--device cuda|cpu]``.  Env (``constants.py``): TRAININGJOB_SERVE_SLOTS,
_MAX_LEN, _PREFILL_CHUNK, _QUEUE_CAP, _RATE, _REQUESTS (0 = serve
forever), _QUANT (Llama only; ignored for MoE, as in JAX), plus
GEN_FAMILY=llama|moe (any value but "moe" is Llama), LLAMA_CONFIG=tiny|
124m|7b or MOE_CONFIG=tiny|8x7b, and TRAININGJOB_CHECKPOINT_DIR: ``main``
serves the family's trainer's checkpoint (``<dir>/llama`` or
``<dir>/moe``; the parameters only, as ``generate``), or a seeded random
init where there is none, and sends its serve and request records to
TRAININGJOB_TELEMETRY_ADDR (``obs/telemetry.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from trainingjob_operator_tpu_torch import constants, resolve_device
from trainingjob_operator_tpu_torch.models import decode, moe_decode

#: Slot states: FREE rows ride the batched step as junk rows, PREFILL rows
#: consume one prompt chunk per tick, DECODE rows emit one token per tick.
FREE, PREFILL, DECODE = 0, 1, 2

#: Cap on per-request phase-transition entries (a ring past that).
PHASE_LOG_CAP = 64

#: Ticks between two serve-level telemetry records (``emit_serve``).
EMIT_EVERY = 32

#: Distinct prompt patterns in ``synthetic_traffic``.
TEMPLATES = 6


class QueueFull(Exception):
    """Raised by ``submit`` when the bounded admission queue is full."""


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    admitted: float = 0.0
    first_token_at: float = 0.0
    finished: float = 0.0
    slot: int = -1
    tokens: List[int] = field(default_factory=list)
    phase_log: Deque[Tuple[str, float]] = field(
        default_factory=lambda: deque(maxlen=PHASE_LOG_CAP))

    def mark(self, phase: str, now: float) -> None:
        self.phase_log.append((phase, now))

    @property
    def ttft_ms(self) -> float:
        return max(self.first_token_at - self.arrival, 0.0) * 1000.0

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean inter-token gap, ms; None before the second token."""
        if not self.finished or not self.first_token_at \
                or len(self.tokens) < 2:
            return None
        span = max(self.finished - self.first_token_at, 0.0) * 1000.0
        return span / (len(self.tokens) - 1)

    def phase_attribution(self, now: float) -> Dict[str, float]:
        """Per-phase wall ms of the lifecycle so far."""
        out: Dict[str, float] = {}
        if self.admitted:
            out["queued"] = max(self.admitted - self.arrival, 0.0) * 1000.0
            if self.first_token_at:
                out["prefill"] = max(
                    self.first_token_at - self.admitted, 0.0) * 1000.0
                end = self.finished or now
                out["decode"] = max(
                    end - self.first_token_at, 0.0) * 1000.0
            else:
                out["prefill"] = max(now - self.admitted, 0.0) * 1000.0
        elif self.arrival:
            out["queued"] = max(now - self.arrival, 0.0) * 1000.0
        return out


class _Slot:
    __slots__ = ("state", "req", "t", "pending", "prefill_pos", "last_emit")

    def __init__(self) -> None:
        self.state = FREE
        self.req: Optional[Request] = None
        self.t = 0             # next cache position this slot writes
        self.pending = 0       # last sampled token (next decode input)
        self.prefill_pos = 0   # prompt tokens already prefilled
        self.last_emit = 0.0   # wall time of this slot's last token


#: The model module of each family: its ``serve_step`` and
#: ``prefill_chunk`` drive the plane.
FAMILIES = {"llama": decode, "moe": moe_decode}


class DecodeService:
    """Continuous-batching scheduler over one fixed-shape decode batch.

    ``params`` (fp or weight-only int8, on ``device``) and the KV cache
    ([L, slots, max_len, Hkv, Dh], allocated once) live on ``device``;
    ``family`` ("llama" or "moe") picks the model module.
    ``max_len`` must be a multiple of ``prefill_chunk``: a last chunk that
    ran past the cache could not be written where its positions say (the
    JAX package's ``dynamic_update_slice`` would clamp it to shifted
    positions).  ``emitter`` is the telemetry hook (``emit_serve`` /
    ``emit_request``); None disables it.
    """

    def __init__(self, params, config, *, slots: int = 4,
                 max_len: Optional[int] = None, prefill_chunk: int = 16,
                 queue_cap: int = 64, eos_id: int = -1,
                 family: str = "llama", policy: str = "continuous",
                 emitter=None, device="cuda"):
        self.device = resolve_device(device)
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r}; expected one of "
                             f"{sorted(FAMILIES)}")
        self.family = family
        self.model = FAMILIES[family]
        if config.sliding_window:
            raise ValueError(
                "the serving plane requires a full-causal cache "
                "(sliding_window == 0): chunked prefill and per-slot "
                "paging do not compose with the ring layout")
        self.max_len = max_len or config.max_seq_len
        if prefill_chunk < 1 or self.max_len % prefill_chunk:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of "
                f"prefill_chunk {prefill_chunk}: a last chunk past the "
                f"cache end cannot be written at its own positions")
        self.params = params
        self.config = config
        self.slots = [_Slot() for _ in range(slots)]
        self.prefill_chunk = prefill_chunk
        self.queue_cap = queue_cap
        self.eos_id = eos_id
        self.policy = policy
        self.emitter = emitter
        self.cache = decode.init_cache(config, slots, self.max_len,
                                       device=self.device)

        self.queue: Deque[Request] = deque()
        self._next_rid = 0
        self.epoch = f"{os.getpid()}-{id(self):x}"
        self._prefill_rr = 0
        self.step_count = 0
        self.completed_total = 0
        #: Plain counter of QueueFull rejections.
        self.rejected_total = 0
        self.tokens_total = 0
        #: Executable calls, for checks that count kernel launches.
        self.decode_calls = 0
        self.prefill_calls = 0
        self._latency_ms: Deque[float] = deque(maxlen=2048)
        self._emit_times: Deque[float] = deque(maxlen=2048)

    def _ids(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.long, device=self.device)

    def warmup(self) -> None:
        """Dispatch each of the three paths once (there is nothing to
        compile ahead; on the card the first dispatch builds and loads the
        kernels).  Leaves slot 0 zeroed, like the JAX warmup."""
        n = len(self.slots)
        zeros = self._ids([0] * n)
        self.model.prefill_chunk(self.params, self.cache,
                                 self._ids([0] * self.prefill_chunk), 0, 0,
                                 self.config)
        self.model.serve_step(self.params, self.cache, zeros, zeros,
                              self.config)
        decode.reset_slot(self.cache, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request surface ------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int,
               now: Optional[float] = None) -> Request:
        """Enqueue one request; raises ``QueueFull`` at capacity and
        ``ValueError`` when it could never fit the cache."""
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_len {self.max_len}")
        if max_new_tokens < 1 or not prompt:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        now = time.time() if now is None else now
        req = Request(rid=self._next_rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, arrival=now)
        self._next_rid += 1
        req.mark("enqueued", now)
        if len(self.queue) >= self.queue_cap:
            self.rejected_total += 1
            self._emit_request(req, "rejected", now)
            raise QueueFull(
                f"queue at capacity {self.queue_cap}; retry or shed")
        self.queue.append(req)
        return req

    # -- scheduler ------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[Request]:
        """One scheduler tick: admit -> one prefill chunk -> one batched
        decode step.  Returns the requests that completed this tick."""
        now = time.time() if now is None else now
        self._admit(now)
        self._prefill_one(now)
        done = self._decode(now)
        self.step_count += 1
        if (self.emitter is not None
                and self.step_count % EMIT_EVERY == 0):
            s = self.stats(now)
            self.emitter.emit_serve(
                queue_depth=s["queue_depth"],
                active_slots=s["active_slots"], slots=s["slots"],
                p50_ms=s["token_latency_ms_p50"],
                p99_ms=s["token_latency_ms_p99"],
                tokens_per_sec=s["tokens_per_sec"],
                completed=s["completed_total"])
        return done

    def _admit(self, now: float) -> None:
        if self.policy == "static":
            # Static batching: a new batch forms only once EVERY slot is
            # free.
            if any(sl.state != FREE for sl in self.slots):
                return
        for idx, sl in enumerate(self.slots):
            if not self.queue:
                return
            if sl.state != FREE:
                continue
            req = self.queue.popleft()
            self.cache = decode.reset_slot(self.cache, idx)
            sl.state = PREFILL
            sl.req = req
            sl.t = 0
            sl.prefill_pos = 0
            req.admitted = now
            req.slot = idx
            req.mark("admitted", now)

    def _prefill_one(self, now: float) -> None:
        """Advance at most ONE slot by one prompt chunk per tick."""
        n = len(self.slots)
        for off in range(n):
            idx = (self._prefill_rr + off) % n
            sl = self.slots[idx]
            if sl.state != PREFILL:
                continue
            req = sl.req
            chunk = req.prompt[sl.prefill_pos:
                               sl.prefill_pos + self.prefill_chunk]
            valid = len(chunk)
            chunk = chunk + [0] * (self.prefill_chunk - valid)
            logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache, self._ids(chunk), idx,
                sl.prefill_pos, self.config)
            self.prefill_calls += 1
            sl.prefill_pos += valid
            req.mark("prefill_chunk", now)
            if sl.prefill_pos >= len(req.prompt):
                # The last VALID chunk offset's logit is the prompt's
                # next-token distribution; one scalar D2H.
                first = int(torch.argmax(logits[valid - 1]))
                sl.state = DECODE
                sl.t = len(req.prompt)
                sl.pending = first
                req.first_token_at = now
                req.mark("first_token", now)
                self._emit_token(sl, first, now)
            self._prefill_rr = (idx + 1) % n
            return

    def _decode(self, now: float) -> List[Request]:
        active = [i for i, sl in enumerate(self.slots)
                  if sl.state == DECODE]
        if not active:
            return []
        # Fixed-shape batch: every row steps.  FREE / mid-PREFILL rows get
        # their next UNWRITTEN position.
        toks, ts = [], []
        for sl in self.slots:
            if sl.state == DECODE:
                toks.append(sl.pending)
                ts.append(sl.t)
            elif sl.state == PREFILL:
                toks.append(0)
                ts.append(sl.prefill_pos)
            else:
                toks.append(0)
                ts.append(0)
        logits, self.cache = self.model.serve_step(
            self.params, self.cache, self._ids(toks), self._ids(ts),
            self.config)
        self.decode_calls += 1
        # Argmax on the device, one D2H of [slots] picks per tick.
        picks = torch.argmax(logits, dim=-1).tolist()
        done: List[Request] = []
        for i in active:
            sl = self.slots[i]
            if sl.req.finished:
                # Completed during this tick's prefill phase (single-token
                # request): nothing reads its row's output.
                done.append(self._release(sl, now))
                continue
            sl.t += 1
            nxt = int(picks[i])
            sl.pending = nxt
            self._emit_token(sl, nxt, now)
            if sl.req.finished:
                done.append(self._release(sl, now))
        return done

    def _emit_token(self, sl: _Slot, tok: int, now: float) -> None:
        req = sl.req
        req.tokens.append(tok)
        self.tokens_total += 1
        if len(req.tokens) > 1:
            self._latency_ms.append((now - sl.last_emit) * 1000.0)
        else:
            self._latency_ms.append(req.ttft_ms)
        sl.last_emit = now
        self._emit_times.append(now)
        if (tok == self.eos_id
                or len(req.tokens) >= req.max_new_tokens
                or len(req.prompt) + len(req.tokens) >= self.max_len):
            req.finished = now

    def _release(self, sl: _Slot, now: float) -> Request:
        """Free the slot; the next admission pass re-pages it."""
        req = sl.req
        sl.state = FREE
        sl.req = None
        self.completed_total += 1
        req.mark("completed", now)
        self._emit_request(req, "completed", now)
        return req

    def _emit_request(self, req: Request, outcome: str, now: float) -> None:
        if self.emitter is None:
            return
        self.emitter.emit_request(
            outcome, req.rid, self.epoch, self._next_rid - 1,
            ttft_ms=req.ttft_ms if req.first_token_at else None,
            tpot_ms=req.tpot_ms, tokens=len(req.tokens),
            arrival=req.arrival, phase_ms=req.phase_attribution(now))

    def drain_abort(self, now: Optional[float] = None) -> List[Request]:
        """Abandon all in-flight work at a drain, scale-in or restart
        boundary (JAX's ``drain_abort``): the queued requests, then the
        slotted ones, each file an ``evicted`` terminal record, so the
        audit ledger never counts them as lost; the slots are freed and
        the evicted requests returned for a router to retry elsewhere."""
        now = time.time() if now is None else now
        evicted: List[Request] = []
        while self.queue:
            evicted.append(self.queue.popleft())
        for sl in self.slots:
            if sl.state != FREE and sl.req is not None:
                evicted.append(sl.req)
                sl.state = FREE
                sl.req = None
        for req in evicted:
            req.mark("evicted", now)
            self._emit_request(req, "evicted", now)
        return evicted

    # -- introspection --------------------------------------------------------

    def stats(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The plane's counters and latency quantiles; ``now`` is the
        caller's clock, taken as JAX's ``stats`` takes it."""
        now = time.time() if now is None else now
        lat = sorted(self._latency_ms)

        def q(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(int(p * len(lat)), len(lat) - 1)]

        span = (self._emit_times[-1] - self._emit_times[0]
                if len(self._emit_times) > 1 else 0.0)
        tps = (len(self._emit_times) - 1) / span if span > 0 else 0.0
        active = sum(1 for sl in self.slots if sl.state != FREE)
        return {
            "policy": self.policy,
            "slots": len(self.slots),
            "active_slots": active,
            "occupancy": active / max(len(self.slots), 1),
            "queue_depth": len(self.queue),
            "steps": self.step_count,
            "completed_total": self.completed_total,
            "rejected_total": self.rejected_total,
            "tokens_total": self.tokens_total,
            "tokens_per_sec": round(tps, 2),
            "token_latency_ms_p50": round(q(0.5), 3),
            "token_latency_ms_p99": round(q(0.99), 3),
        }


# -- synthetic open-loop traffic ---------------------------------------------

def synthetic_traffic(n: int, *, seed: int = 0, rate: float = 0.5,
                      vocab: int = 256,
                      prompt_lens: Tuple[int, int] = (4, 16),
                      out_tokens: Tuple[int, int] = (4, 32)
                      ) -> List[Tuple[int, List[int], int]]:
    """``n`` requests as (arrival_tick, prompt, max_new) triples: Poisson
    arrivals in tick time, prompts from ``TEMPLATES`` deterministic token
    patterns (so identical requests recur in different slots), mixed
    prompt/output lengths; the same seed gives the JAX package's trace."""
    import random

    rng = random.Random(seed)
    tick = 0
    out: List[Tuple[int, List[int], int]] = []
    for _ in range(n):
        while rng.random() > rate:
            tick += 1
        g = rng.randrange(TEMPLATES)
        plen = rng.randint(*prompt_lens)
        prompt = [1 + (g * 37 + 7 * i) % (vocab - 1) for i in range(plen)]
        out.append((tick, prompt, rng.randint(*out_tokens)))
    return out


def run_traffic(service: DecodeService,
                traffic: List[Tuple[int, List[int], int]],
                max_ticks: int = 100000) -> Dict[str, Any]:
    """Drive ``service`` through an open-loop trace, then drain; returns
    stats + completed requests + the stale-KV self-check verdict."""
    completed: List[Request] = []
    submitted = 0
    i = 0
    tick = 0
    t0 = time.time()
    while i < len(traffic) or any(sl.state != FREE for sl in service.slots) \
            or service.queue:
        while i < len(traffic) and traffic[i][0] <= tick:
            _, prompt, max_new = traffic[i]
            try:
                service.submit(prompt, max_new)
                submitted += 1
            except QueueFull:
                pass  # open-loop shed; counted in rejected_total
            i += 1
        completed.extend(service.step())
        tick += 1
        if tick > max_ticks:
            raise RuntimeError(f"traffic did not drain in {max_ticks} ticks")
    wall = time.time() - t0
    stats = service.stats()
    stats.update({
        "submitted": submitted,
        "wall_s": round(wall, 3),
        "aggregate_tokens_per_sec": round(
            service.tokens_total / wall, 1) if wall > 0 else 0.0,
        "stale_kv_violations": count_stale_kv_violations(completed),
        "ttft_ms_p50": _quantile([r.ttft_ms for r in completed], 0.5),
    })
    return {"stats": stats, "completed": completed}


def count_stale_kv_violations(completed: List[Request]) -> int:
    """Identical (prompt, max_new) requests must decode identically in any
    slot; returns the number of divergent requests."""
    reference: Dict[Tuple[Tuple[int, ...], int], List[int]] = {}
    violations = 0
    for req in completed:
        key = (tuple(req.prompt), req.max_new_tokens)
        ref = reference.setdefault(key, req.tokens)
        if req.tokens != ref:
            violations += 1
    return violations


def _quantile(values: List[float], p: float) -> float:
    if not values:
        return 0.0
    v = sorted(values)
    return round(v[min(int(p * len(v)), len(v) - 1)], 3)


# -- entry point -------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.serve")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    from trainingjob_operator_tpu_torch.workloads.generate import family_of

    _, device = rendezvous.prepare_worker(args.device,
                                          subdir=family_of(os.environ))
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.obs.telemetry import TelemetryEmitter
    from trainingjob_operator_tpu_torch.workloads.generate import (
        family_config,
        restore_params,
    )

    env = os.environ
    family, cfg = family_config(env)
    slots = int(env.get(constants.SERVE_SLOTS_ENV, "4"))
    max_len = int(env.get(constants.SERVE_MAX_LEN_ENV, "0")) or None
    chunk = int(env.get(constants.SERVE_PREFILL_CHUNK_ENV, "16"))
    queue_cap = int(env.get(constants.SERVE_QUEUE_CAP_ENV, "64"))
    rate = float(env.get(constants.SERVE_RATE_ENV, "0.5"))
    n_requests = int(env.get(constants.SERVE_REQUESTS_ENV, "200"))
    quantize = env.get(constants.SERVE_QUANT_ENV, "") in ("1", "true")

    # The checkpoint contract of workloads/generate.py: the trained
    # parameters where a checkpoint exists, a random init otherwise.
    params, step = restore_params(cfg, device, family)
    print(f"serving the checkpoint at step {step}" if step else
          "serving a seeded random init (no checkpoint found)", flush=True)
    if quantize and family != "moe":
        from trainingjob_operator_tpu_torch.models.quant import (
            quantize_weights)

        params = quantize_weights(params)
        print("serving weight-only int8", flush=True)

    service = DecodeService(params, cfg, slots=slots, max_len=max_len,
                            prefill_chunk=chunk, queue_cap=queue_cap,
                            family=family, emitter=TelemetryEmitter(),
                            device=device)
    print(f"serve: family={family} device={device} slots={slots} "
          f"max_len={service.max_len} chunk={chunk} queue_cap={queue_cap} "
          f"rate={rate}", flush=True)

    if n_requests > 0:
        traffic = synthetic_traffic(n_requests, rate=rate,
                                    vocab=cfg.vocab_size)
        result = run_traffic(service, traffic)
        s = result["stats"]
        print(f"serve done: completed={s['completed_total']} "
              f"rejected={s['rejected_total']} "
              f"tokens/s={s['aggregate_tokens_per_sec']} "
              f"p50_ms={s['token_latency_ms_p50']} "
              f"p99_ms={s['token_latency_ms_p99']} "
              f"stale_kv_violations={s['stale_kv_violations']}", flush=True)
        return 0 if s["stale_kv_violations"] == 0 else 1

    batch_no = 0
    while True:
        traffic = synthetic_traffic(512, seed=batch_no, rate=rate,
                                    vocab=cfg.vocab_size)
        run_traffic(service, traffic)
        batch_no += 1


if __name__ == "__main__":
    sys.exit(main())
