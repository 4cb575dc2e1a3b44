"""The port's native IQ reader (io/native.py, native/iqreader.cpp) and the
FileSampleSource that reads through it, held to the bit to the plain numpy
conversion (io/sources.py:convert_numpy) and to the JAX package's
FileSampleSource on the same files, for the dtypes and offsets of
tests/test_io.py:72-105; the prefetch across sequential reads, a peek and a
moved cursor; the build's place; and a failing build raising.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import numpy as np
import pytest

from gypsum_tpu.io.sources import FileSampleSource as JaxFileSampleSource
from gypsum_tpu.io.sources import RecordingInfo as JaxRecordingInfo
from gypsum_tpu_torch.core.events import NoMoreSamplesError
from gypsum_tpu_torch.io import native
from gypsum_tpu_torch.io.native import NativeIqReader
from gypsum_tpu_torch.io.sources import (
    DecimatingSampleSource,
    FileSampleSource,
    RecordingInfo,
    convert_numpy,
)

FS = 2.046e6
L = 2046
CASES = [(np.float32, 0.0), (np.int16, 0.0), (np.int8, 0.0), (np.uint8, 127.5)]
IDS = ["float32", "int16", "int8", "uint8-127.5"]


def write_capture(tmp_path, n, dtype, offset, seed=0):
    """tests/test_io.py:_write_capture of ``n`` samples of Gaussian IQ."""
    rng = np.random.default_rng(seed)
    iq = (rng.standard_normal(n) * 20 + 1j * rng.standard_normal(n) * 20).astype(np.complex64)
    words = np.empty(2 * n, dtype=dtype)
    if dtype == np.float32:
        words[0::2], words[1::2] = iq.real, iq.imag
    else:
        info = np.iinfo(dtype)
        words[0::2] = np.clip(np.round(iq.real + offset), info.min, info.max)
        words[1::2] = np.clip(np.round(iq.imag + offset), info.min, info.max)
    path = tmp_path / f"cap_{np.dtype(dtype).name}.bin"
    words.tofile(path)
    return path, words


@pytest.mark.parametrize("dtype,offset", CASES, ids=IDS)
def test_reader_equals_numpy_and_jax_to_the_bit(tmp_path, dtype, offset):
    path, words = write_capture(tmp_path, 12 * L + 7, dtype, offset)
    info = RecordingInfo(path=path, sample_rate=FS, component_dtype=dtype, component_offset=offset)
    reader = NativeIqReader(info)
    assert reader.n_samples == 12 * L + 7
    for start, count in [(0, 12 * L + 7), (1001, 513), (12 * L, 7)]:
        got = reader.read(start, count)
        assert got.dtype == np.complex64
        assert got.tobytes() == convert_numpy(words, start, count, offset).tobytes()
    with pytest.raises(EOFError):
        reader.read(12 * L, 8)

    port = FileSampleSource(info)
    jax = JaxFileSampleSource(JaxRecordingInfo(path=path, sample_rate=FS, component_dtype=dtype,
                                               component_offset=offset))
    for n_ms in (3, 3, 1, 4):
        ts, block = port.read_block(n_ms)
        jts, jblock = jax.read_block(n_ms)
        assert ts == jts and block.shape == (n_ms, L)
        assert block.tobytes() == np.asarray(jblock, dtype=np.complex64).tobytes()
    assert port._native.prefetched_reads == 1  # the second 3 ms block
    with pytest.raises(NoMoreSamplesError):
        port.read_block(2)  # 1 ms and 7 samples left


def test_prefetch_serves_only_its_own_block(tmp_path):
    """Sequential reads come from the prefetch; a peek, another length and a
    cursor moved after a prefetch (as a resume sets it) are read on the spot
    and still get their own samples."""
    path, words = write_capture(tmp_path, 40 * L, np.int16, 0.0)
    src = FileSampleSource(RecordingInfo(path=path, sample_rate=FS, component_dtype=np.int16))

    def want(start_ms, n_ms):
        return convert_numpy(words, start_ms * L, n_ms * L, 0.0).reshape(n_ms, L).tobytes()

    hits = lambda: src._native.prefetched_reads  # noqa: E731
    assert src.read_block(5)[1].tobytes() == want(0, 5) and hits() == 0
    assert src.read_block(5)[1].tobytes() == want(5, 5) and hits() == 1
    # A peek of the queued block takes the prefetch; the read after it is
    # converted on the spot, and both are the same samples.
    assert src.peek_block(5)[1].tobytes() == want(10, 5) and hits() == 2
    assert src.read_block(5)[1].tobytes() == want(10, 5) and hits() == 2
    assert src.read_block(5)[1].tobytes() == want(15, 5) and hits() == 3
    # Another length than the one queued.
    assert src.read_block(3)[1].tobytes() == want(20, 3) and hits() == 3
    # The cursor moved after a prefetch was queued (23 ms queued).
    src._cursor = 30 * L + 11
    got = src.read_block(2)[1]
    assert got.tobytes() == convert_numpy(words, 30 * L + 11, 2 * L, 0.0).tobytes()
    assert hits() == 3
    got = src.read_block(2)[1]
    assert got.tobytes() == convert_numpy(words, 32 * L + 11, 2 * L, 0.0).tobytes()
    assert hits() == 4
    # 5 ms and 2035 samples are left: a 6 ms read is refused and the last
    # whole block still reads.
    with pytest.raises(NoMoreSamplesError):
        src.read_block(6)
    assert src.read_block(5)[1].tobytes() == convert_numpy(
        words, 34 * L + 11, 5 * L, 0.0).reshape(5, L).tobytes()
    src._native.close()
    src._native.close()  # closing twice is harmless
    with pytest.raises(ValueError):
        src._native.read(0, 1)


def test_decimating_front_end_reads_the_file_through_the_reader(tmp_path):
    """A decimating source reads the file with its own lengths (the first
    read differs from the rest): its blocks equal those it makes from the
    same samples in memory."""
    from gypsum_tpu_torch.io.sources import ArraySampleSource

    path, words = write_capture(tmp_path, 16 * 4 * L, np.int8, 0.0)
    iq = convert_numpy(words, 0, 16 * 4 * L, 0.0)
    info = RecordingInfo(path=path, sample_rate=4 * FS, component_dtype=np.int8)
    from_file = DecimatingSampleSource(FileSampleSource(info), FS, device="cpu")
    in_memory = DecimatingSampleSource(ArraySampleSource(iq, 4 * FS), FS, device="cpu")
    for _ in range(4):
        assert from_file.read_block(3)[1].tobytes() == in_memory.read_block(3)[1].tobytes()
    assert from_file.inner._native.prefetched_reads >= 1


def test_build_lands_under_build_native(tmp_path):
    package = native.SOURCE.parent.parent
    before = sorted(p for p in package.rglob("*") if "__pycache__" not in p.parts)
    lib = native.build()
    assert lib.parent == package.parent / "build" / "native"
    assert lib.name.startswith("libiqreader_") and lib.suffix == ".so" and lib.exists()
    path, _ = write_capture(tmp_path, L, np.float32, 0.0)
    FileSampleSource(RecordingInfo(path=path, sample_rate=FS)).read_block(1)
    after = sorted(p for p in package.rglob("*") if "__pycache__" not in p.parts)
    assert after == before


def test_failing_compiler_raises(tmp_path, monkeypatch):
    """No fallback: a build that fails raises with the compiler's output."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "--no-such-flag"))
    path, _ = write_capture(tmp_path, L, np.float32, 0.0)
    with pytest.raises(RuntimeError, match=r"(?s)native IQ reader.*failed.*no-such-flag"):
        FileSampleSource(RecordingInfo(path=path, sample_rate=FS))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        NativeIqReader(RecordingInfo(path=path, sample_rate=FS))
    assert not list((tmp_path / "native").glob("*.so"))
