"""The GPipe pipeline (``trainingjob_operator_tpu_torch/parallel/
pipeline.py``) against the JAX package's ``parallel/pipeline.py``, in one
process.  The schedule across processes is held to JAX's and to one
process by the Llama cases of tests/test_torch_parallel.py (pp=2,
pp=2 x fsdp=2, pp=2 x sp=2) and by the trainer cases of
tests/test_torch_sp_pp_train.py.

- ``bubble_fraction`` equals JAX's.
- At pp = 1 ``gpipe`` is the loop over the layers; a mesh without a pp
  axis, a batch the microbatches do not divide and a layer count pp does
  not divide are refused with JAX's types and messages.
- ``touch`` passes its first input on and gives the others zero
  gradients.
"""

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from trainingjob_operator_tpu.parallel import pipeline as jpipe  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import pipeline as tpipe  # noqa: E402


class _Stage:
    """One rank's view of a mesh (``size``, ``coord``, ``axis_names``)
    without a process group: enough for what ``gpipe`` checks before its
    first hand-off."""

    def __init__(self, **sizes):
        spec = tmesh.MeshSpec.of(**sizes)
        self.sizes = spec.sizes
        self.axis_names = spec.names

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def coord(self, axis):
        return 0


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 1), (2, 8), (4, 8),
                                          (4, 24), (8, 56)])
def test_bubble_fraction_equals_jax(stages, micro):
    assert tpipe.bubble_fraction(stages, micro) == \
        jpipe.bubble_fraction(stages, micro)


def test_one_stage_is_the_layer_loop():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    layers = [torch.from_numpy(rng.standard_normal((3, 3)).astype(
        np.float32)) for _ in range(3)]
    want = h
    for w in layers:
        want = torch.tanh(want @ w)
    got = tpipe.gpipe(lambda x, w: torch.tanh(x @ w), layers, h,
                      _Stage(pp=1, fsdp=1), n_microbatches=4)
    assert torch.equal(got, want)
    jl = jnp.stack([jnp.asarray(w.numpy()) for w in layers])
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(pp=1, fsdp=1),
                         devices=jax.devices()[:1])
    jgot = jpipe.gpipe(lambda x, w: jnp.tanh(x @ w), jl,
                       jnp.asarray(h.numpy()), jm, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6,
                               atol=1e-6)


def _refusal(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_a_mesh_without_pp_is_refused_as_jax_refuses_it():
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(fsdp=2), devices=jax.devices()[:2])
    want = _refusal(lambda: jpipe.gpipe(lambda x, w: x, jnp.zeros((2, 2, 2)),
                                        jnp.zeros((4, 2)), jm, 2))
    got = _refusal(lambda: tpipe.gpipe(lambda x, w: x, [None] * 2,
                                       torch.zeros(4, 2), _Stage(fsdp=2), 2))
    assert got == want and "no 'pp'" in got


def test_a_batch_the_microbatches_do_not_divide_is_refused():
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(pp=2), devices=jax.devices()[:2])
    want = _refusal(lambda: jpipe.gpipe(lambda x, w: x, jnp.zeros((4, 2, 2)),
                                        jnp.zeros((6, 2)), jm, 4))
    got = _refusal(lambda: tpipe.gpipe(lambda x, w: x, [None] * 2,
                                       torch.zeros(6, 2), _Stage(pp=2), 4))
    assert got == want == "batch 6 not divisible by microbatches=4"


def test_layers_the_stages_do_not_divide_are_refused():
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(pp=2), devices=jax.devices()[:2])
    want = _refusal(lambda: jpipe.gpipe(lambda x, w: x, jnp.zeros((3, 2, 2)),
                                        jnp.zeros((4, 2)), jm, 2))
    cfg = tllama.LlamaConfig.tiny(n_layers=3)
    assert _refusal(lambda: tllama.check_pp(cfg, 2)) == want
    assert _refusal(lambda: tllama.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu",
        mesh=_Stage(pp=2))) == want
    tllama.check_pp(tllama.LlamaConfig.tiny(n_layers=4), 2)


def test_touch_passes_its_input_and_zeroes_the_others():
    out = torch.arange(3.0, requires_grad=True)
    other = torch.ones(2, 2, requires_grad=True)
    plain = torch.ones(5)
    y = tpipe.touch(out, other, plain)
    assert torch.equal(y, out)
    (y * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    assert torch.equal(out.grad, torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(other.grad, torch.zeros(2, 2))
    assert plain.grad is None
