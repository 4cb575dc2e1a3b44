"""Phase 1's sample operand (ops/iq_operand.py) against the chain the
two-phase tracker ran before it: dequantize_planes -> to_complex ->
.real/.imag -> the product's precision -> torch.cat([cr, ci]) per stream.

The operand and phase 1's sums must be identical to the bit: the new path
reads the same words and rounds them once, as the chain did, and the
products see the same operand values in the same shapes. On the card the
kernel (csrc/iq_operand.cu) is held to the plain version by chip_smoke.py.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import math

import numpy as np
import pytest
import torch

from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu_torch.core.planes import dequantize_planes, to_complex
from gypsum_tpu_torch.ops.correlate import ascending_lag_rows, lag_window
from gypsum_tpu_torch.ops.iq_operand import iq_operand, iq_operand_cuda
from gypsum_tpu_torch.signal.prn import replica_table
from gypsum_tpu_torch.track.loop import device_state, fresh_state
from gypsum_tpu_torch.track.matmul import lag_window_size, make_matmul_track_block_fn

FS, L, B = 2.046e6, 2046, 20
# A farm of 3 streams with 4, 2 and 3 channels, in no order.
FARM_SOC = np.array([2, 0, 1, 0, 2, 2, 1, 0, 0])

WORDS = {
    "int8": (torch.int8, 0.0),
    "uint8 offset 127.5": (torch.uint8, 127.5),
    "int16": (torch.int16, 0.0),
    "float32": (torch.float32, 0.0),
    "complex64": (torch.complex64, 0.0),
}


def _block(words: str, shape: tuple, seed: int) -> tuple[torch.Tensor, float]:
    """Random words over each type's whole range ([..., 2] planes, or
    complex64 of shape[:-1]) and the input offset."""
    dtype, offset = WORDS[words]
    rng = np.random.default_rng(seed)
    if dtype == torch.complex64:
        x = rng.normal(0.0, 300.0, shape).astype(np.float32)
        return torch.view_as_complex(torch.from_numpy(x)), offset
    if dtype == torch.float32:
        return torch.from_numpy(rng.normal(0.0, 300.0, shape).astype(np.float32)), offset
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, dtype=dtype,
                         generator=torch.Generator().manual_seed(seed)), offset


def _to_mm(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The tracker's CPU rounding to the product's precision."""
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def _old_planes(samples: torch.Tensor, offset: float, bf16: bool):
    """cr, ci [B, (N,) L] as the tracker made them before the operand kernel."""
    if samples.is_complex():
        chunks = samples.to(torch.complex64)
    else:
        chunks = to_complex(dequantize_planes(samples, offset))
    return _to_mm(chunks.real.contiguous(), bf16), _to_mm(chunks.imag.contiguous(), bf16)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
@pytest.mark.parametrize("layout", ["single", "farm"])
@pytest.mark.parametrize("words", list(WORDS))
def test_plain_operand_equals_the_old_chain(words, layout, bf16):
    # An odd L for the single stream: the kernel's scalar loop.
    shape = (B, 31, 2) if layout == "single" else (B, 3, 62, 2)
    samples, offset = _block(words, shape, seed=len(words) + len(layout))
    cr, ci = _old_planes(samples, offset, bf16)
    want = [torch.cat([cr, ci])] if layout == "single" else [
        torch.cat([cr[:, n], ci[:, n]]) for n in range(3)]
    got = iq_operand(samples, offset, bf16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(want), *want[0].shape)
    for n, w in enumerate(want):
        assert torch.equal(got[n], w), f"stream {n} differs"
    # Every stream's rows start 256 bytes apart, as a fresh tensor's would.
    assert got.stride()[1:] == (shape[-2], 1)
    assert got.stride(0) * got.element_size() % 256 == 0


def _old_phase1(cfg, state, samples, replicas, soc, offset):
    """corr_r, corr_i [B, S, NLE] as track/matmul.py computed them before
    the operand kernel: the lag rows, the wipe, the samples' planes and one
    product a stream on torch.cat([cr, ci])."""
    nle = lag_window_size(cfg, L)
    k_eff = (nle - 1) // 2
    aiding_scale = L / (cfg.aiding_carrier_hz or GPS_L1_FREQUENCY_HZ) if cfg.carrier_aiding else 0.0
    st = device_state(state, torch.device("cpu"))
    predicted_mid = -aiding_scale * st.doppler * (cfg.block_size_ms / 2.0)
    cpi0 = torch.remainder(torch.floor(st.code_phase + predicted_mid).to(torch.int64), L)
    rows = ascending_lag_rows(lag_window(replicas, cpi0, L, k_eff), L)
    l_over_fs = torch.from_numpy((np.arange(L) / FS).astype(np.float32))
    phase0 = st.carrier_phase[:, None] + (
        2.0 * math.pi * (st.doppler + st.carrier_offset)[:, None] * l_over_fs[None, :])
    c0, s0 = torch.cos(phase0), torch.sin(phase0)
    rows_lj = rows.transpose(1, 2)
    bf16 = cfg.matmul_tracker_bf16
    w_r = _to_mm(rows_lj * c0[:, :, None], bf16)
    w_i = _to_mm(-rows_lj * s0[:, :, None], bf16)
    cr, ci = _old_planes(samples, offset, bf16)

    def product(cr, ci, w_r, w_i):
        b_count, s_count = cr.shape[0], w_r.shape[0]
        w = torch.stack([w_r, w_i]).permute(2, 0, 1, 3).reshape(L, -1)
        prod = torch.mm(torch.cat([cr, ci]), w).reshape(2, b_count, 2, s_count, nle)
        return prod[0, :, 0] - prod[1, :, 1], prod[0, :, 1] + prod[1, :, 0]

    if soc is None:
        return product(cr, ci, w_r, w_i)
    corr_r = torch.empty((B, len(soc), nle), dtype=torch.float32)
    corr_i = torch.empty_like(corr_r)
    for n in np.unique(soc):
        idx = torch.as_tensor(np.flatnonzero(soc == n))
        corr_r[:, idx], corr_i[:, idx] = product(cr[:, n], ci[:, n], w_r[idx], w_i[idx])
    return corr_r, corr_i


PHASE1 = {
    "single int8": ("single", "int8"),
    "single uint8 offset 127.5": ("single", "uint8 offset 127.5"),
    "farm int8": ("farm", "int8"),
    "farm complex64": ("farm", "complex64"),
}


@pytest.fixture
def one_thread():
    """One torch thread while two products are held to the bit: how a
    threaded CPU GEMM splits its sums must not depend on the box's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
@pytest.mark.parametrize("case", list(PHASE1))
def test_phase1_sums_equal_the_old_chain(case, bf16, one_thread):
    layout, words = PHASE1[case]
    soc = FARM_SOC if layout == "farm" else None
    s_count = len(FARM_SOC) if soc is not None else 5
    shape = (B, L, 2) if soc is None else (B, 3, L, 2)
    samples, offset = _block(words, shape, seed=3)
    cfg = TrackingConfig(block_size_ms=B, matmul_tracker_bf16=bf16)
    rng = np.random.default_rng(5)
    reps = replica_table(L)
    k = cfg.lag_window_half_width
    wide = np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)
    replicas = torch.from_numpy(wide[rng.integers(0, 32, s_count)])
    state = fresh_state(s_count)._replace(
        code_phase=rng.uniform(0, L, s_count).astype(np.float32),
        carrier_phase=rng.uniform(0, 2 * np.pi, s_count).astype(np.float32),
        doppler=rng.uniform(-4000, 4000, s_count).astype(np.float32),
        carrier_offset=rng.choice([0.0, 562.5e3, -1125e3], s_count).astype(np.float32),
    )
    fn = make_matmul_track_block_fn(cfg, L, FS, s_count, stream_of_channel=soc,
                                    input_offset=offset, device="cpu")
    _, _, corr_r, corr_i = fn.phase1(state, samples, replicas)
    want_r, want_i = _old_phase1(cfg, state, samples, replicas, soc, offset)
    assert torch.equal(corr_r, want_r) and torch.equal(corr_i, want_i)


REFUSED = {
    "float64 planes": (torch.zeros((4, 6, 2), dtype=torch.float64), ValueError, "int8"),
    "three words a sample": (torch.zeros((4, 6, 3), dtype=torch.int8), ValueError, "planes"),
    "a CPU tensor": (torch.zeros((4, 6, 2), dtype=torch.int8), ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cuda_entry_refuses_what_the_kernel_does_not_take(case):
    """The kernel's entry raises before any launch; it never falls back to
    the plain version."""
    samples, error, match = REFUSED[case]
    with pytest.raises(error, match=match):
        iq_operand_cuda(samples, 0.0, torch.bfloat16)
