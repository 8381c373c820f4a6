"""The port's ``write_tokens`` (``data/tokens.py``) against the JAX
package's: the same bytes for a vocab that fits uint16 and one that needs
uint32, the same refusals, and a corpus the port's ``TokenDataset`` reads
back."""

import numpy as np
import pytest

from trainingjob_operator_tpu.data import tokens as jtokens
from trainingjob_operator_tpu_torch.data import TokenDataset, write_tokens
from trainingjob_operator_tpu_torch.data import tokens as ttokens


@pytest.mark.parametrize("vocab,dtype", [(200, np.uint16),
                                         (65536, np.uint16),
                                         (70000, np.uint32),
                                         (None, np.uint16)])
def test_bytes_equal_jax(tmp_path, vocab, dtype):
    top = vocab or 1000
    ids = np.random.default_rng(5).integers(0, top, 3000)
    ids[7] = top - 1
    want, got = tmp_path / "jax.tokens", tmp_path / "port.tokens"
    assert jtokens.write_tokens(str(want), ids, vocab_size=vocab) == 3000
    assert write_tokens(str(got), ids, vocab_size=vocab) == 3000
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_bytes()) == ttokens.HEADER_BYTES + 3000 * np.dtype(
        dtype).itemsize
    ds = TokenDataset(str(got))
    assert ds.vocab_size == (vocab or top)
    assert len(ds) == 3000
    np.testing.assert_array_equal(np.asarray(ds._tokens), ids)
    assert not list(tmp_path.glob("*.tmp.*"))


@pytest.mark.parametrize("ids,vocab,match", [
    ([3, -1, 4], 10, "negative token id -1"),
    ([3, 10, 4], 10, "token id 10 >= vocab_size 10"),
    ([[1, 2]], 10, "must be 1-D"),
])
def test_refusals_equal_jax(tmp_path, ids, vocab, match):
    for write in (jtokens.write_tokens, write_tokens):
        path = tmp_path / "x.tokens"
        with pytest.raises(ValueError, match=match):
            write(str(path), np.asarray(ids), vocab_size=vocab)
        assert not path.exists()
