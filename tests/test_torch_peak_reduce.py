"""K2 (ops/peak_reduce.py): the plain version against the JAX Pallas kernel
(interpret mode, as tests/test_pallas_kernels.py runs it) and numpy.

Max and argmax are exact (ties to the lowest index); the sum agrees to
rtol 1e-6 (float32 sums of a few thousand terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.ops.pallas_kernels import peak_reduce_pallas
from gypsum_tpu_torch.ops import peak_reduce as pr

SHAPES = [(1, 1), (7, 3001), (33, 129), (5, 2047), (29, 2046)]


def _with_ties(rng, rows, n):
    x = rng.random((rows, n)).astype(np.float32)
    x[:, n // 3] = 2.0  # two planted maxima per row: the lower index wins
    x[:, n - 1] = 2.0
    return x


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_matches_pallas_and_numpy(rng, shape):
    x = _with_ties(rng, *shape)
    jm, ja, js = (np.asarray(v) for v in peak_reduce_pallas(jnp.asarray(x), interpret=True))
    tm, ta, ts = (v.numpy() for v in pr.peak_reduce_reference(torch.from_numpy(x)))
    assert ta.dtype == np.int32
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta, np.argmax(x, axis=1))
    np.testing.assert_array_equal(tm, x.max(axis=1))
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    np.testing.assert_allclose(ts, x.sum(axis=1, dtype=np.float64), rtol=1e-6)


def test_all_equal_row_picks_index_zero():
    x = np.zeros((3, 100), np.float32)
    _, arg, _ = pr.peak_reduce_reference(torch.from_numpy(x))
    assert arg.tolist() == [0, 0, 0]
    _, jarg, _ = peak_reduce_pallas(jnp.asarray(x), interpret=True)
    assert np.asarray(jarg).tolist() == [0, 0, 0]


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch(rng):
    x = torch.from_numpy(_with_ties(rng, 4, 50))
    before = pr.PEAK_REDUCE_KERNEL.launches
    out = pr.peak_reduce(x)
    ref = pr.peak_reduce_reference(x)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert pr.PEAK_REDUCE_KERNEL.launches == before


def test_kernel_wrapper_refuses_a_cpu_tensor():
    # The kernel route never falls back: a CPU tensor handed to it raises
    # before anything is built or launched.
    with pytest.raises(ValueError, match="CUDA tensor"):
        pr.peak_reduce_cuda(torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="rows, n"):
        pr.peak_reduce_cuda(torch.zeros(8))
