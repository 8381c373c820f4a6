"""Serving traffic for an open loop: requests due at times fixed in
advance, whether or not the server keeps up.

Arrivals are Poisson at ``rate`` requests a second (exponential gaps);
prompt and output lengths are lognormal (a median and a sigma each),
clipped to what a slot holds.  All three are drawn from the seed, by
stratified sampling: every ``STRATA`` requests take one gap and one of
each length from each of ``STRATA`` bands of equal probability, at a
point in the band and in an order drawn from the seed.  So each draw
follows its distribution, every seed sends its own schedule, and every
``STRATA`` requests of any seed hold about as much work: the seed moves
the bursts, not the load.  Prompt token ids are uniform, drawn from the
seed.

A traffic file of this kind holds ``{"generator": "serve_open_loop",
"prompt": {"median", "sigma", "min", "max"}, "output": {...}}``; the
cell gives the rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Callable, Iterator, List

import numpy as np

from benchmark import weights

#: Requests a round of stratified draws covers.
STRATA = 64
#: Keeps a band's point off 0 and 1, where the inverse CDFs are infinite.
_EDGE = 1e-12


@dataclass
class Arrival:
    index: int
    due_s: float          # seconds after the loop's start
    prompt: List[int]
    max_new: int


def stratified(inverse_cdf: Callable[[float], float],
               rng: np.random.Generator) -> List[float]:
    """``STRATA`` draws of a distribution, one from each band of equal
    probability, at a point in the band and in an order drawn from
    ``rng``."""
    u = (np.arange(STRATA) + rng.random(STRATA)) / STRATA
    return [inverse_cdf(float(min(max(x, _EDGE), 1.0 - _EDGE)))
            for x in rng.permutation(u)]


def _length(spec: dict) -> Callable[[float], int]:
    mu, sigma, z = math.log(spec["median"]), spec["sigma"], NormalDist()

    def inverse(u: float) -> int:
        n = round(math.exp(mu + sigma * z.inv_cdf(u)))
        return int(min(max(n, spec["min"]), spec["max"]))

    return inverse


def arrivals(traffic: dict, rate: float, seed: int,
             vocab: int) -> Iterator[Arrival]:
    """The endless schedule of the seed, in order of due time."""
    prompt, output = _length(traffic["prompt"]), _length(traffic["output"])

    def gap(u: float) -> float:
        return -math.log1p(-u) / rate

    t, index, block = 0.0, 0, 0
    while True:
        rng = np.random.Generator(np.random.PCG64(
            weights.sub_seed(seed, "serve", block)))
        gaps = stratified(gap, rng)
        prompts = stratified(prompt, rng)
        outputs = stratified(output, rng)
        for g, p, o in zip(gaps, prompts, outputs):
            t += g
            ids = rng.integers(0, vocab, p).tolist()
            yield Arrival(index, t, ids, o)
            index += 1
        block += 1
