"""Memory-mapped token datasets with stateless deterministic sampling.

Own copy of the JAX package's ``data/tokens.py`` reader and writer (that
module is numpy-only, but the port imports nothing of the JAX package).
Reads and writes (``write_tokens``) the same ``.tokens`` files: a
16-byte header -- magic ``b"AITJTOK1"``, then uint32 dtype code (2 =
uint16, 4 = uint32) and uint32 vocab size -- followed by the flat token
stream.

Sampling is stateless: ``batch(step)`` derives every row's window offset
from ``(seed, step, row)`` with the same splitmix-style hash as the JAX
package, so both packages draw byte-identical batches from one file.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

MAGIC = b"AITJTOK1"
_DTYPES = {2: "uint16", 4: "uint32"}
_CODES = {v: k for k, v in _DTYPES.items()}
HEADER_BYTES = 16


def write_tokens(path: str, tokens, vocab_size: Optional[int] = None) -> int:
    """Serialize a 1-D int array to the ``.tokens`` format; returns the
    count.  The ids are stored as uint16 when the vocab fits (<= 65536),
    else uint32; a negative id, or one at or past ``vocab_size`` (which a
    narrower dtype would wrap into a wrong token), is refused.  The file
    is written under a temporary name and committed by ``os.replace``, so
    a reader never sees half of it."""
    arr = np.asarray(tokens)
    if arr.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {arr.shape}")
    top = int(arr.max()) if arr.size else 0
    if arr.size and int(arr.min()) < 0:
        raise ValueError(f"negative token id {int(arr.min())}")
    hi = int(vocab_size) if vocab_size else top + 1
    if top >= hi:
        raise ValueError(f"token id {top} >= vocab_size {hi}")
    dtype = "uint16" if hi <= 65536 else "uint32"
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC + struct.pack("<II", _CODES[dtype], hi))
        f.write(arr.astype(dtype).tobytes())
    os.replace(tmp, path)
    return int(arr.size)


class TokenDataset:
    """Random-access window sampler over a memory-mapped token file.

    ``region=(lo, hi)`` restricts sampling to that fraction of the stream,
    a real train/eval split: held-out data must be disjoint tokens, not a
    different sampling seed over the same tokens.
    """

    def __init__(self, path: str, seed: int = 0,
                 region: "tuple[float, float]" = (0.0, 1.0)):
        with open(path, "rb") as f:
            head = f.read(HEADER_BYTES)
        if len(head) != HEADER_BYTES or head[:8] != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC.decode()} token file")
        code, vocab = struct.unpack("<II", head[8:])
        if code not in _DTYPES:
            raise ValueError(f"{path}: unknown dtype code {code}")
        lo, hi = region
        if not (0.0 <= lo < hi <= 1.0):
            raise ValueError(f"bad region {region}")
        self.path = path
        #: ids are < vocab_size (0 on files from before the field existed).
        self.vocab_size = int(vocab)
        self.seed = int(seed)
        self.region = (float(lo), float(hi))
        self._tokens = np.memmap(path, dtype=_DTYPES[code], mode="r",
                                 offset=HEADER_BYTES)
        if self._tokens.size == 0:
            raise ValueError(f"{path}: empty token stream")

    def __len__(self) -> int:
        return int(self._tokens.size)

    def check_window(self, window: int) -> None:
        """Raise unless the region holds at least one ``window``-token
        sample (the startup-time misconfiguration check)."""
        self._offsets(0, 1, window)

    def _offsets(self, step: int, rows: int, window: int):
        """Window start offsets for every row of global step ``step``: a
        splitmix64-style avalanche of (seed, step, row)."""
        lo = int(len(self) * self.region[0])
        hi = int(len(self) * self.region[1])
        span = (hi - lo) - window
        if span < 0:
            raise ValueError(
                f"{self.path}: region {self.region} holds {hi - lo} "
                f"tokens < window {window}")
        with np.errstate(over="ignore"):  # uint64 wraparound is the hash
            x = (np.uint64(self.seed) * np.uint64(0x9E3779B97F4A7C15)
                 + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
                 + np.arange(rows, dtype=np.uint64)
                 * np.uint64(0x94D049BB133111EB))
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            x *= np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
        return (np.uint64(lo) + x % np.uint64(span + 1)).astype(np.int64)

    def batch(self, step: int, batch: int, seq: int, *,
              rows: Optional[slice] = None) -> np.ndarray:
        """[rows, seq + 1] int32 windows for global step ``step`` (input and
        next-token target); ``rows`` selects a slice of the global batch."""
        offs = self._offsets(step, batch, seq + 1)
        if rows is not None:
            offs = offs[rows]
        out = np.empty((len(offs), seq + 1), np.int32)
        for i, o in enumerate(offs):
            out[i] = self._tokens[o:o + seq + 1]
        return out
