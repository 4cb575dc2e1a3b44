"""parallel/ of the port (torch.distributed) against gypsum_tpu/parallel/.

One launch of four gloo ranks on the CPU (a sat 2 x time 2 mesh,
tests/_torch_dist_worker.py, which imports only the port) runs the sharded
sweep (and a tie planted across shards), the halo sweep, the sharded fast
tracker, the channel-sharded block of the default tracker and the farm on
the inputs of tests/test_parallel.py and tests/test_farm.py. This process
computes the JAX references meanwhile, on a 2 x 2 mesh of the virtual CPU
devices (the same shards). Tolerances are those of the JAX tests the inputs
come from; every rank's results must be identical. A second launch, in
which one rank raises before its first collective, must fail within its
time limit rather than hang.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.planes import to_planes
from gypsum_tpu.ops.correlate import replica_fft_conj_table
from gypsum_tpu.parallel.mesh import make_receiver_mesh as jax_mesh
from gypsum_tpu.parallel.sharded import make_sharded_track_block_fn as jax_sharded_track
from gypsum_tpu.parallel.sharded import shard_tracking_inputs as jax_shard_inputs
from gypsum_tpu.parallel.sharded import sharded_acquisition_sweep as jax_sweep
from gypsum_tpu.parallel.streaming import time_sharded_correlation_power as jax_stream
from gypsum_tpu.signal.prn import replica_table, sampled_replica
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu.track.loop import fresh_state
from gypsum_tpu.track.loop import make_farm_track_block_fn as jax_farm
from gypsum_tpu.track.loop import make_track_block_fn as jax_track
from gypsum_tpu_torch.ops import fixup as fx
from gypsum_tpu_torch.parallel.mesh import factor_devices, make_receiver_mesh
from tests._torch_dist_worker import launch

FS, L = 2.046e6, 2046
TIE_ROWS = (3, 20, 22)  # PRN 17's row (16) copied here: 3 in shard 0, 16-22 in shard 1


def _wide():
    reps = replica_table(L)
    k = JaxTrackingConfig().lag_window_half_width
    return np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)


def _inputs() -> dict:
    """tests/test_parallel.py's and tests/test_farm.py's inputs."""
    truth = SyntheticSatellite(prn=17, doppler_hz=1500.0, delay_samples=321, amplitude=0.3)
    sweep_iq = synthesize_iq([truth], 4 * L, FS, noise_sigma=0.3, seed=4).reshape(4, L)
    pfc = to_planes(replica_fft_conj_table(replica_table(L)))
    tie = pfc.copy()
    tie[list(TIE_ROWS)] = pfc[16]

    # 16 chunks over 4 ranks (4 each); the burst crosses the rank 0 -> 1 edge.
    rng = np.random.default_rng(0xC0FFEE)
    rep = sampled_replica(5, L).real.astype(np.float32)
    n = 16 * L
    stream = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    stream[4 * L - 700: 5 * L - 700] += 0.8 * rep.astype(np.complex64)

    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    wide = _wide()
    replicas = np.tile(wide[8][None, :], (8, 1))

    farm_sats = [
        SyntheticSatellite(prn=5, doppler_hz=900.0, delay_samples=300, amplitude=0.3),
        SyntheticSatellite(prn=23, doppler_hz=-2500.0, delay_samples=1500, amplitude=0.3),
    ]
    farm_streams = [
        synthesize_iq([farm_sats[0]], 40 * L, FS, noise_sigma=0.25, seed=41).reshape(40, L),
        synthesize_iq([farm_sats[1]], 40 * L, FS, noise_sigma=0.25, seed=42).reshape(40, L),
    ]
    return {
        "sweep_samples": to_planes(sweep_iq),
        "dopplers": np.arange(-2000.0, 2001.0, 500.0).astype(np.float32),
        "sweep_pfc": pfc,
        "tie_pfc": tie,
        "stream_iq": to_planes(stream),
        "stream_rep": rep,
        "fast_iq": to_planes(synthesize_iq([sat], 12 * L, FS, noise_sigma=0.2, seed=9).reshape(12, L)),
        "fast_replicas": replicas,
        "scan_iq": to_planes(synthesize_iq([sat], 8 * L, FS, noise_sigma=0.2, seed=9).reshape(8, L)),
        "scan_replicas": replicas,
        "farm_streams": np.array([0, 0, 1, 1], dtype=np.int32),
        "farm_samples": np.stack([to_planes(s) for s in farm_streams], axis=1),  # [B, N, L, 2]
        "farm_replicas": wide[[4, 4, 22, 22]],
    }


def _references(inp: dict) -> dict:
    """The JAX package's results on a 2 x 2 mesh of four virtual devices."""
    mesh = jax_mesh(jax.devices()[:4])
    assert mesh.shape == {"sat": 2, "time": 2}
    ref = {}
    for name in ("sweep", "tie"):
        ref[name] = [np.asarray(r) for r in jax.device_get(jax_sweep(
            mesh, jnp.asarray(inp["sweep_samples"]), jnp.asarray(inp["dopplers"]),
            jnp.asarray(inp[f"{name}_pfc"]), FS))]
    ref["stream"] = np.asarray(jax_stream(mesh, jnp.asarray(inp["stream_iq"]), inp["stream_rep"]))

    state = fresh_state(8)
    state = state._replace(doppler=state.doppler + 700.0, code_phase=state.code_phase + 100.0)
    cfg = JaxTrackingConfig(block_size_ms=12, use_matmul_tracker=True, matmul_tracker_bf16=False,
                            fixup_backend="pallas", fixup_group_ms=6)
    ref["fast"] = jax.device_get(jax_sharded_track(mesh, cfg, L, FS, 8)(
        state, jnp.asarray(inp["fast_iq"]), jnp.asarray(inp["fast_replicas"])))
    fn = jax_track(JaxTrackingConfig(block_size_ms=8), L, FS, 8)
    ref["scan"] = jax.device_get(fn(*jax_shard_inputs(
        mesh, state, jnp.asarray(inp["scan_iq"]), jnp.asarray(inp["scan_replicas"]))))

    farm_state = fresh_state(4)._replace(
        doppler=np.array([900.0, 900.0, -2500.0, -2500.0], np.float32),
        code_phase=np.array([300.0, 300.0, 1500.0, 1500.0], np.float32),
    )
    cfg_farm = JaxTrackingConfig(block_size_ms=40, lag_window_block_margin=10)
    ref["farm"] = jax.device_get(jax_farm(cfg_farm, L, FS, 4, inp["farm_streams"])(
        farm_state, jnp.asarray(inp["farm_samples"]), jnp.asarray(inp["farm_replicas"])))
    return ref


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The four ranks' results (rank 0's first) and the JAX references,
    computed while the ranks run."""
    directory = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    np.savez(directory / "inputs.npz", **inp)
    ranks = launch("parallel", 4, directory)
    ref = _references(inp)
    rcs, outs, timed_out = ranks.wait(timeout=240)
    assert not timed_out and rcs == [0] * 4, "\n".join(o[-3000:] for o in outs)
    return ranks.results(), ref, inp


def test_factor_devices():
    assert factor_devices(8) == (4, 2)
    assert factor_devices(16) == (4, 4)
    assert factor_devices(7) == (7, 1)
    assert factor_devices(1) == (1, 1)


def test_mesh_needs_a_process_group_and_a_fitting_shape(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_receiver_mesh("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match=r"mesh 2x1 != 1"):
            make_receiver_mesh("cpu", 2, 1)
        mesh = make_receiver_mesh("cpu")
        assert mesh.mesh_dim_names == ("sat", "time") and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["sweep", "tie"])
def test_sharded_sweep_matches_jax(launched, name):
    results, ref, _ = launched
    strength, d_idx, code_phase, best_row, best_val = results[0][name]
    j_strength, j_d, j_cp, j_row, j_val = ref[name]
    np.testing.assert_array_equal(d_idx, j_d)
    np.testing.assert_array_equal(code_phase, j_cp)
    assert int(best_row) == int(j_row)
    np.testing.assert_allclose(strength, j_strength, rtol=1e-5)
    np.testing.assert_allclose(best_val, j_val, rtol=1e-5)
    if name == "sweep":
        assert int(best_row) == 16 and int(code_phase[16]) == 321
    else:
        # Four rows hold PRN 17's replica, 3 in shard 0 and 16, 20, 22 in
        # shard 1: within a shard the lowest row wins, across shards the
        # highest.
        assert strength[3] == strength[16] == strength[20] == strength[22]
        assert int(best_row) == 16


def test_halo_sweep_matches_jax(launched):
    results, ref, inp = launched
    power = results[0]["stream"]
    assert power.shape == (16, L)
    np.testing.assert_allclose(power, ref["stream"], rtol=1e-4, atol=1e-3)
    ci, lag = np.unravel_index(np.argmax(power), power.shape)
    assert ci * L + lag == 4 * L - 700  # the burst across the rank 0 -> 1 edge


def _hold_tracker(state, outs, j_state, j_outs):
    """tests/test_parallel.py's tolerances, locked exact."""
    for field in ("prompt_i", "prompt_q"):
        np.testing.assert_allclose(outs[field], np.asarray(getattr(j_outs, field)),
                                   rtol=1e-4, atol=1e-2)
    for field in ("doppler", "code_phase"):
        np.testing.assert_allclose(state[field], np.asarray(getattr(j_state, field)).ravel(),
                                   rtol=1e-5)
    np.testing.assert_array_equal(outs["locked"], np.asarray(j_outs.locked))


def test_sharded_fast_tracker_matches_jax(launched):
    results, ref, _ = launched
    state, outs = results[0]["fast"]
    assert outs["prompt_i"].shape == (12, 8)
    _hold_tracker(state, outs, *ref["fast"])


def test_channel_sharded_block_matches_jax(launched):
    results, ref, _ = launched
    carry, outs = results[0]["scan"]  # [8 carry rows, S], [B, N_OUT, S]
    state = {"code_phase": carry[fx.CP], "doppler": carry[fx.FD]}
    out = {"prompt_i": outs[:, fx.O_PI], "prompt_q": outs[:, fx.O_PQ],
           "locked": outs[:, fx.O_LOCKED] > 0.5}
    assert out["prompt_i"].shape == (8, 8)
    _hold_tracker(state, out, *ref["scan"])


def test_farm_matches_jax_and_each_stream_alone(launched):
    """tests/test_farm.py's bars: the port's farm against the JAX farm, and
    against each of its streams tracked alone, which it equals to the bit
    (each stream's channels are correlated as one product, as alone)."""
    results, ref, _ = launched
    state, outs = results[0]["farm"]
    j_state, j_outs = ref["farm"]
    np.testing.assert_allclose(state["doppler"], np.asarray(j_state.doppler).ravel(), rtol=1e-6)
    np.testing.assert_allclose(state["code_phase"], np.asarray(j_state.code_phase).ravel(),
                               rtol=1e-6)
    np.testing.assert_allclose(outs["prompt_i"], np.asarray(j_outs.prompt_i), rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(outs["locked"], np.asarray(j_outs.locked))
    for n, (s1, o1) in enumerate(results[0]["farm_alone"]):
        cols = slice(2 * n, 2 * n + 2)
        np.testing.assert_allclose(state["doppler"][cols], s1["doppler"], rtol=1e-6)
        np.testing.assert_allclose(state["code_phase"][cols], s1["code_phase"], rtol=1e-6)
        np.testing.assert_allclose(outs["prompt_i"][:, cols], o1["prompt_i"], rtol=1e-5, atol=1e-2)
        np.testing.assert_array_equal(outs["locked"][:, cols], o1["locked"])
        for field in s1:
            np.testing.assert_array_equal(state[field][cols], s1[field])
        for field in o1:
            np.testing.assert_array_equal(outs[field][:, cols], o1[field])


def test_indivisible_rows_channels_and_streams_raise(launched):
    results, _, _ = launched
    refused = results[0]["refused"]
    assert len(refused) == 4, refused
    assert "31 PRN rows not divisible by sat axis 2" in refused[0]
    assert "7 channels not divisible by sat axis 2" in refused[1]
    assert "across 2 time shards" in refused[2]  # JAX's own check
    assert "across 4 ranks" in refused[3]  # 6 chunks: whole over 'time', not over the ranks


def test_every_rank_holds_the_same_results(launched):
    results, _, _ = launched
    first = pickle.dumps(results[0])
    for rank, res in enumerate(results[1:], 1):
        assert pickle.dumps(res) == first, f"rank {rank} differs from rank 0"


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises before its first collective; rank 0, waiting in it,
    must fail on its own (the group's 10 s timeout at the latest), well
    inside the launcher's limit."""
    rcs, outs, timed_out = launch("fail", 2, tmp_path, threads=1, timeout_s=10).wait(timeout=90)
    assert not timed_out, "the launch hung until its time limit"
    assert rcs[1] != 0 and "rank 1 fails before its first collective" in outs[1]
    assert rcs[0] != 0, outs[0][-2000:]
