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


def _as_kernel_buffer(results):
    """The three results laid out as the kernel writes them: one [3, rows]
    buffer of 4-byte words, the argmax row holding int32 bits."""
    mx, arg, sm = results
    buf = torch.empty((3, mx.shape[0]), dtype=torch.float32)
    buf[0], buf[2] = mx, sm
    buf[1].view(torch.int32).copy_(arg)
    return buf


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "4_byte_offset_view"])
@pytest.mark.parametrize("shape", SHAPES + [(9, 2), (9, 3)], ids=str)
def test_one_buffer_output_gives_the_same_three_results(rng, shape, offset):
    """The wrapper on the CPU route, on a contiguous view ``offset`` floats
    into its storage, and the same results read back through the kernel's
    one-buffer layout (split_results), against the TPU kernel in interpret
    mode and numpy."""
    rows, n = shape
    flat = np.zeros(rows * n + offset, np.float32)
    flat[offset:] = _with_ties(rng, rows, n).ravel()
    x = torch.from_numpy(flat)[offset:].view(rows, n)
    assert x.is_contiguous() and x.storage_offset() == offset
    direct = pr.peak_reduce(x)
    split = pr.split_results(_as_kernel_buffer(direct))
    jm, ja, js = (np.asarray(v) for v in peak_reduce_pallas(jnp.asarray(x.numpy()), interpret=True))
    for tm, ta, ts in (direct, split):
        assert ta.dtype == torch.int32 and tm.dtype == ts.dtype == torch.float32
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_equal(ta.numpy(), ja)
        np.testing.assert_array_equal(ta.numpy(), np.argmax(x.numpy(), axis=1))
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
    for a, b in zip(direct, split):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_views", [False, True], ids=["three_tensors", "views_of_one_buffer"])
def test_coarse_peak_keeps_its_results_with_one_buffer(rng, monkeypatch, use_views):
    """coarse_peak through the wrapper equals the flat-argmax route, also
    when the wrapper hands it three views of one buffer as the kernel does."""
    from gypsum_tpu_torch.acquire import engine

    noncoh = torch.from_numpy(rng.random((3, 5, 64)).astype(np.float32))
    noncoh[1, 2, 17] = noncoh[1, 4, 3] = 4.0  # a tie across Doppler bins
    if use_views:
        monkeypatch.setattr(
            engine, "peak_reduce", lambda x: pr.split_results(_as_kernel_buffer(pr.peak_reduce(x))))
    got = engine.coarse_peak(noncoh, use_kernel=True)
    want = engine.coarse_peak(noncoh, use_kernel=False)
    assert got[0].tolist() == want[0].tolist() and got[1].tolist() == want[1].tolist()
    assert got[0][1] == 2 and got[1][1] == 17
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-5)
