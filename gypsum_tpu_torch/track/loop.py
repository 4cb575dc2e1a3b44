"""Tracking contract and the host-side bank of tracking channels.

Torch port of the contract and bank of gypsum_tpu/track/loop.py. Reference
behavior (gypsum/tracker.py): each millisecond, wipe off the carrier with the
current Doppler/phase estimate, correlate early/prompt/late replicas, update
the code phase from an early-late power discriminator, update carrier phase
and Doppler with a second-order Costas loop whose bandwidth depends on lock
state, emit the prompt as a +/-1 pseudosymbol, and watch lock quality to
detect lost lock.

One call tracks every channel over a whole block (default 1000 ms): by
default with the two-phase tracker of ``track/matmul.py``, by configuration
with the per-ms scan tracker of ``track/scan.py`` or the whole-block kernel
of ``ops/track_block.py`` (``make_track_block_fn`` says which). The
``TrackerBank`` owns channel
assignment (satellite <-> slot), turns block outputs into timestamped
pseudosymbol streams, and mirrors the reference's drop/reacquire semantics.
The loop carry stays on the device between dispatches; host edits
(assign, release, rescue, coast) bring it back first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gypsum_tpu_torch.core import aot
from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.obs import spans
from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS, replica_table


class TrackState(NamedTuple):
    """Loop-filter carry, one entry per channel ([S]-shaped leaves: numpy on
    the host, tensors on the device)."""

    code_phase: object  # f32, fractional samples in [0, L)
    carrier_phase: object  # f32, NCO phase mod 2*pi
    doppler: object  # f32 Hz
    # Static per-channel carrier frequency offset (Hz) joined to the wipeoff
    # and NCO advance but NOT to carrier aiding or the PLL state: the FDMA
    # sub-band offset of a GLONASS channel, zero for GPS/SBAS channels.
    carrier_offset: object  # f32 Hz
    ema_err: object  # f32 — EMA of the Costas error
    ema_err_sq: object  # f32 — EMA of its square (for variance)
    ema_quality: object  # f32 — EMA of (I^2-Q^2)/(I^2+Q^2)
    step_count: object  # i32 — ms processed since (re)init
    lost: object  # bool — sticky lost-lock flag


class TrackBlockOutputs(NamedTuple):
    """Per-millisecond observables, [B, S]-shaped (ms-major)."""

    prompt_i: object  # f32 — Re(prompt correlation peak)
    prompt_q: object  # f32 — Im(prompt correlation peak)
    code_phase: object  # f32 — code phase used for this ms (loop state)
    # Sub-sample code-phase measurement: the lag-window peak refined by
    # triangle (or HRC) interpolation; feeds pseudoranges.
    code_phase_measured: object  # f32
    doppler: object  # f32
    carrier_phase: object  # f32
    pll_error: object  # f32 — normalized Costas error
    dll_error: object  # f32 — normalized early-late discriminator
    locked: object  # bool
    quality: object  # f32 — EMA lock quality at this ms
    lost: object  # bool — sticky


def fresh_state(n_channels: int) -> TrackState:
    """Host-side (numpy) initial state."""
    z = np.zeros((n_channels,), dtype=np.float32)
    return TrackState(
        code_phase=z,
        carrier_phase=z.copy(),
        doppler=z.copy(),
        carrier_offset=z.copy(),
        ema_err=z.copy(),
        ema_err_sq=z.copy(),
        ema_quality=z.copy(),
        step_count=np.zeros((n_channels,), dtype=np.int32),
        lost=np.zeros((n_channels,), dtype=bool),
    )


def device_state(state: TrackState, device: torch.device) -> TrackState:
    """``state`` as [S] tensors on ``device``. Accepts numpy or tensor leaves,
    [S] or [S, 1]; host (numpy) leaves are copied, since the bank edits its
    host state in place."""
    return TrackState(*(
        (torch.tensor(a) if isinstance(a, np.ndarray) else a).to(device).reshape(-1)
        for a in state
    ))


def carry_rows(state: TrackState) -> list[torch.Tensor]:
    """The loop carry of a device TrackState as the first eight float32 rows
    of the kernels' [N_CARRY, S] arrays (ops/fixup.py: CP .. LOST)."""
    f32 = torch.float32
    return [
        state.code_phase.to(f32), state.carrier_phase.to(f32), state.doppler.to(f32),
        state.ema_err.to(f32), state.ema_err_sq.to(f32), state.ema_quality.to(f32),
        state.step_count.to(f32), state.lost.to(f32),
    ]


def state_from_carry(fin: torch.Tensor, carrier_offset: torch.Tensor) -> TrackState:
    """A TrackState from the first eight rows of a final carry [N_CARRY, S]."""
    from gypsum_tpu_torch.ops import fixup as fx

    return TrackState(
        code_phase=fin[fx.CP],
        carrier_phase=fin[fx.TH],
        doppler=fin[fx.FD],
        carrier_offset=carrier_offset,
        ema_err=fin[fx.EERR],
        ema_err_sq=fin[fx.EERR2],
        ema_quality=fin[fx.EQ],
        step_count=fin[fx.STEP].to(torch.int32),
        lost=fin[fx.LOST] > 0.5,
    )


def block_fn_from_packed(packed):
    """``f(state, samples_block, replicas_wide) -> (state', TrackBlockOutputs)``
    around ``packed``, which returns the outputs as one [B, N_OUT, S] float32
    tensor (rows in ``ops/fixup.py``'s ``O_*`` order) instead. ``f.packed`` is
    what the bank carries to the host in one copy."""
    from gypsum_tpu_torch.ops import fixup as fx

    def track_block(state, samples_block: torch.Tensor, replicas_wide: torch.Tensor):
        new_state, outs = packed(state, samples_block, replicas_wide)
        outputs = TrackBlockOutputs(
            prompt_i=outs[:, fx.O_PI],
            prompt_q=outs[:, fx.O_PQ],
            code_phase=outs[:, fx.O_CP],
            code_phase_measured=outs[:, fx.O_CPM],
            doppler=outs[:, fx.O_FD],
            carrier_phase=outs[:, fx.O_TH],
            pll_error=outs[:, fx.O_PLL],
            dll_error=outs[:, fx.O_DLL],
            locked=outs[:, fx.O_LOCKED] > 0.5,
            quality=outs[:, fx.O_QUAL],
            lost=outs[:, fx.O_LOST] > 0.5,
        )
        return new_state, outputs

    track_block.packed = packed
    return track_block


# Block trackers are pure functions of their (hashable) build parameters:
# each closes over read-only tables (the sample times, the farm's channel
# groups, the fixup's constants) and keeps no state between calls (the
# carry and the pinned output copies belong to each TrackerBank). So one is
# shared process-wide, as gypsum_tpu/track/loop.py:_TRACK_FN_CACHE shares
# its jitted programs, and a restarted receiver (a checkpoint's, a
# campaign's, a second run in one process) rebuilds no tracker tables.
_TRACK_FN_CACHE: dict = {}


def make_track_block_fn(
    config: TrackingConfig,
    samples_per_prn: int,
    sample_rate: float,
    n_channels: int,
    stream_of_channel: np.ndarray | None = None,
    input_offset: float = 0.0,
    device: str | torch.device = "cuda",
):
    """Build (or fetch the process-wide shared) block-tracking function on
    ``device``, and start the preload of the kernels it launches
    (``core/aot.py``; ``f.libraries`` names them).

    Returns ``f(state, samples_block, replicas_wide) -> (state', outputs)``
    (see track/matmul.py:make_matmul_track_block_fn); ``f.packed`` returns the
    outputs as one [B, N_OUT, S] tensor. With ``stream_of_channel`` ([S] int),
    the farm variant: samples_block is [B, N, L(, 2)] and channel s
    correlates against stream ``stream_of_channel[s]``.

    Which tracker, as in the JAX package:

    - ``use_matmul_tracker`` None means "the two-phase tracker unless
      ``use_pallas_block_tracker`` is True";
    - otherwise ``use_pallas_block_tracker`` True takes the whole-block
      kernel (ops/track_block.py), False the per-ms scan (track/scan.py),
      and None the kernel on a CUDA device and the scan on the CPU;
    - a farm always takes the scan (the block kernel assumes one stream).

    The JAX package also falls back to the scan when the block kernel's lag
    matrix would not fit the TPU's VMEM; the CUDA kernel holds one
    L + 2 K_eff window per channel and no lag matrix, so there is no such
    fallback here.
    """
    dev = resolve_device(device)
    farm_key = (
        None
        if stream_of_channel is None
        else np.asarray(stream_of_channel, dtype=np.int32).tobytes()
    )
    # The key of gypsum_tpu/track/loop.py:make_track_block_fn, with the
    # device where the JAX package keys its backend.
    key = (config, int(samples_per_prn), float(sample_rate), int(n_channels),
           float(input_offset), farm_key, str(dev))
    try:
        fn = _TRACK_FN_CACHE.get(key)
    except TypeError:  # unhashable config field: build uncached
        key, fn = None, None
    if fn is None:
        fn = _build_track_block_fn(config, samples_per_prn, sample_rate, n_channels,
                                   stream_of_channel, input_offset, dev)
        if key is not None:
            _TRACK_FN_CACHE[key] = fn
    aot.preload(fn.libraries, dev)
    return fn


def _build_track_block_fn(cfg, samples_per_prn, sample_rate, n_channels, stream_of_channel,
                          input_offset, dev):
    use_matmul = cfg.use_matmul_tracker
    if use_matmul is None:
        use_matmul = cfg.use_pallas_block_tracker is not True
    if use_matmul:
        from gypsum_tpu_torch.track.matmul import make_matmul_track_block_fn

        return make_matmul_track_block_fn(
            cfg, samples_per_prn, sample_rate, n_channels,
            stream_of_channel=stream_of_channel, input_offset=input_offset, device=dev,
        )

    if stream_of_channel is not None:
        use_block_kernel = False
    else:
        use_block_kernel = cfg.use_pallas_block_tracker
    if use_block_kernel is None:
        use_block_kernel = dev.type == "cuda"
    if use_block_kernel:
        return _make_block_kernel_wrapper(cfg, samples_per_prn, sample_rate, input_offset, dev)

    from gypsum_tpu_torch.track.scan import make_scan_track_block_fn

    return make_scan_track_block_fn(
        cfg, samples_per_prn, sample_rate, n_channels,
        stream_of_channel=stream_of_channel, input_offset=input_offset, device=dev,
    )


def make_farm_track_block_fn(
    config: TrackingConfig,
    samples_per_prn: int,
    sample_rate: float,
    n_channels: int,
    stream_of_channel: np.ndarray,  # [S] int — which stream each channel reads
    device: str | torch.device = "cuda",
):
    """Multi-stream ("replay farm") block tracker: each channel consumes its
    own IQ stream — N independent captures or antennas tracked in one
    dispatch.

    Returns ``f(state, samples_block [B, N, L, 2] float32 planes (or
    [B, N, L] complex), replicas_wide [S, >= 2L + 2K] float32) -> (state',
    TrackBlockOutputs [B, S])``; ``stream_of_channel[s]`` selects the stream
    channel s correlates against.
    """
    return make_track_block_fn(
        config, samples_per_prn, sample_rate, n_channels,
        stream_of_channel=stream_of_channel, device=device,
    )


def _make_block_kernel_wrapper(cfg, length, fs, input_offset, device):
    """Adapt the whole-block kernel (ops/track_block.py) to the
    TrackState/TrackBlockOutputs contract."""
    from gypsum_tpu_torch.core.planes import dequantize_planes, to_planes
    from gypsum_tpu_torch.ops import track_block as tb

    if cfg.code_phase_measurement != "triangle":
        raise ValueError(
            "the legacy block tracker only implements the 'triangle' "
            "code-phase measurement; use the matmul or scan tracker for "
            f"{cfg.code_phase_measurement!r}"
        )
    params = tb.TrackBlockParams.from_config(cfg, length, fs)

    def track_block_packed(state, samples_block: torch.Tensor, replicas_wide: torch.Tensor):
        state = device_state(state, device)
        if samples_block.is_complex():
            planes = to_planes(samples_block)
        else:
            planes = dequantize_planes(samples_block, input_offset)
        rows = torch.stack([*carry_rows(state), torch.zeros_like(state.code_phase, dtype=torch.float32)])
        fin, outs = tb.track_block(rows, planes, replicas_wide, params)
        # The legacy block kernel predates FDMA carrier offsets and ignores
        # them (TrackerBank.assign rejects nonzero offsets when this path is
        # forced); the offset column rides through unchanged.
        return state_from_carry(fin, state.carrier_offset), outs

    fn = block_fn_from_packed(track_block_packed)
    fn.libraries = (tb.TRACK_BLOCK_KERNEL.source,)
    return fn


class _Dispatched(NamedTuple):
    """A dispatched block: its packed outputs [B, N_OUT, S] and what
    collecting it needs."""

    outs: torch.Tensor  # pinned host copy on the card's path, else the CPU result
    ready: object  # torch.cuda.Event recorded after the copy, or None
    n_ms: int
    start_time: float
    slot_prn: list
    doppler: object  # the carry's Doppler [S] after this block (not copied)


@dataclass
class ChannelObservation:
    """Host-side view of one channel's block outputs, timestamped."""

    prn: int
    slot: int
    # Arrays of length B (block size in ms):
    pseudosymbol_signs: np.ndarray  # int8 +/-1
    start_times: np.ndarray  # f64 — code-phase-corrected leading edges
    end_times: np.ndarray  # f64
    prompts: np.ndarray  # c64
    code_phases: np.ndarray  # f32 — loop state
    code_phases_measured: np.ndarray  # f32 — sub-sample interpolated
    dopplers: np.ndarray  # f32
    carrier_phases: np.ndarray  # f32 — NCO phase at each ms
    pll_errors: np.ndarray  # f32 — normalized Costas discriminator
    dll_errors: np.ndarray  # f32 — normalized early-late discriminator
    locked: np.ndarray  # bool
    quality: np.ndarray  # f32
    lost: bool  # sticky lost-lock flag at block end


class TrackerBank:
    """Host orchestration of a fixed bank of tracking channels.

    Channels are static slots (the device arrays have fixed [S] shapes); a
    slot is bound to a PRN at acquisition and freed on lost lock, the
    analogue of the reference's per-satellite pipeline dict
    (reference: gypsum/receiver.py:70-72,225-256).
    """

    def __init__(
        self,
        sample_rate: float,
        samples_per_prn: int,
        config: TrackingConfig | None = None,
        n_channels: int = 12,
        input_offset: float = 0.0,
        prns: tuple[int, ...] = ALL_PRN_IDS,
        device: str | torch.device = "cuda",
        mesh=None,
    ) -> None:
        """``mesh``: a ('sat', 'time') DeviceMesh (parallel/mesh.py). The
        bank's block program becomes the channel-sharded fast tracker
        (parallel/sharded.py:make_sharded_track_block_fn): each rank runs
        the single-device tracker on its n_channels / n_sat slice on
        ``device`` and the block's state and outputs are gathered whole on
        every rank; the host orchestration (assignment, observation
        building, drop/rescue/coast) is unchanged."""
        self.config = config or TrackingConfig()
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.samples_per_prn = int(samples_per_prn)
        self.n_channels = n_channels
        self.prns = tuple(prns)
        self._prn_row = {prn: i for i, prn in enumerate(self.prns)}
        self.mesh = mesh
        if mesh is not None:
            from gypsum_tpu_torch.parallel.sharded import make_sharded_track_block_fn

            self._fn = make_sharded_track_block_fn(
                mesh, self.config, self.samples_per_prn, self.sample_rate,
                n_channels, input_offset=input_offset, device=self.device,
            )
        else:
            self._fn = make_track_block_fn(
                self.config, self.samples_per_prn, self.sample_rate, n_channels,
                input_offset=input_offset, device=self.device,
            )
        k = self.config.lag_window_half_width
        reps = replica_table(self.samples_per_prn, self.prns)  # [N, L]
        self._replicas_wide = np.concatenate(
            [reps, reps, reps[:, : 2 * k]], axis=1
        ).astype(np.float32)  # [N, 2L + 2K]
        self.state = fresh_state(n_channels)
        self.slot_prn: list[int | None] = [None] * n_channels
        self._last_rescue_time = np.full(n_channels, -np.inf)
        self.rescue_counts = np.zeros(n_channels, dtype=int)
        # The carry stays on the device between dispatches; host edits
        # bring it back first (sync_host_state).
        self._device_state: TrackState | None = None
        self._pending: list[_Dispatched] = []  # dispatched-but-uncollected blocks
        # The carry's Doppler after the last COLLECTED block (maybe_rescue).
        self._collected_doppler = None
        self._replica_cache: tuple[bytes | None, torch.Tensor | None] = (None, None)

    # ----------------------------------------------------------- assignment

    def sync_host_state(self) -> None:
        """Bring the authoritative carry back to host numpy (after the latest
        dispatch when the carry is on the device). Host edits
        (assign/release/rescue/coast) require this."""
        if self._device_state is not None:
            self.state = TrackState(*(a.cpu().numpy().copy() for a in self._device_state))
            self._device_state = None

    def invalidate_device_state(self) -> None:
        """Forget any device-resident carry (after externally replacing
        ``self.state``)."""
        self._device_state = None

    def assign(
        self,
        prn: int,
        doppler_hz: float,
        code_phase_samples: float,
        carrier_phase_rad: float,
        carrier_offset_hz: float = 0.0,
    ) -> int:
        """Bind a free slot to a newly acquired satellite; returns the slot.

        ``carrier_offset_hz``: static sub-band offset for FDMA signals;
        ``doppler_hz`` stays the Doppler RELATIVE to that offset."""
        if carrier_offset_hz and self.config.use_pallas_block_tracker is True:
            raise ValueError(
                "the legacy block tracker does not support FDMA "
                "carrier offsets; use the matmul or scan tracker"
            )
        self.sync_host_state()
        try:
            slot = self.slot_prn.index(None)
        except ValueError:
            raise RuntimeError("no free tracking channels") from None
        self.slot_prn[slot] = prn
        s = self.state
        s.code_phase[slot] = code_phase_samples % self.samples_per_prn
        s.carrier_phase[slot] = carrier_phase_rad % (2 * np.pi)
        s.doppler[slot] = doppler_hz
        s.carrier_offset[slot] = carrier_offset_hz
        s.ema_err[slot] = 0.0
        s.ema_err_sq[slot] = 0.0
        s.ema_quality[slot] = 0.0
        s.step_count[slot] = 0
        s.lost[slot] = False
        return slot

    def release(self, slot: int) -> None:
        self.sync_host_state()
        self.slot_prn[slot] = None
        self.state.lost[slot] = False
        self.state.carrier_offset[slot] = 0.0
        self._last_rescue_time[slot] = -np.inf
        self.rescue_counts[slot] = 0

    # -------------------------------------------------------------- rescue

    def maybe_rescue(self, obs: "ChannelObservation", now: float) -> bool:
        """Degradation short of drop (reference: gypsum/tracker.py:380-387):
        when a channel's block-end quality sits in the marginal band
        [quality_drop_threshold, rescue_quality_threshold), correct its
        Doppler in place from the phase slope of the squared prompt stream,
        and reset the lock EMAs and step counter so the watchdog re-warms.
        Returns True if rescued."""
        cfg = self.config
        slot = obs.slot
        if not cfg.rescue_enabled or obs.lost:
            return False
        quality = float(obs.quality[-1])
        if quality >= cfg.rescue_quality_threshold:
            self.rescue_counts[slot] = 0
            return False
        self.sync_host_state()  # rescue edits the carry on the host
        # Quality EMA must have had time to mean anything.
        if int(self.state.step_count[slot]) < cfg.quality_window_ms:
            return False
        if now - self._last_rescue_time[slot] < cfg.rescue_period_s:
            return False

        # Residual Doppler from the squared-prompt phase slope over the last
        # ~250 ms: z = p^2 rotates at twice the residual rate.
        p = obs.prompts[-250:].astype(np.complex128)
        z = p * p
        if len(z) < 8:
            return False
        s = np.sum(z[1:] * np.conj(z[:-1]))
        if abs(s) == 0.0:
            return False
        t_ms = self.samples_per_prn / self.sample_rate
        residual_hz = float(np.angle(s)) / (2.0 * 2.0 * np.pi * t_ms)
        residual_hz = float(
            np.clip(residual_hz, -cfg.rescue_max_correction_hz, cfg.rescue_max_correction_hz)
        )

        st = self.state
        # The residual is the signal's offset from the NCO the COLLECTED
        # block ended on. Pipelined, the carry has since run the in-flight
        # block, and a marginal loop wanders by several Hz over one: re-centre
        # from the collected block's NCO (unpipelined it is the carry).
        base = st.doppler[slot]
        if self._pending:
            base = self._collected_doppler[slot].cpu().numpy()
        st.doppler[slot] = base + residual_hz
        st.ema_err[slot] = 0.0
        st.ema_err_sq[slot] = 0.0
        st.ema_quality[slot] = 0.0
        st.step_count[slot] = 0
        st.lost[slot] = False
        self._last_rescue_time[slot] = now
        self.rescue_counts[slot] += 1
        return True

    def coast_override(self, slot: int, code_phase_samples: float, doppler_hz: float) -> None:
        """Vector coast: drive a blocked channel's code phase and Doppler
        open-loop from the navigation solution's predicted geometry. Lock
        EMAs and the step counter reset each application so the watchdog
        never re-fires on the noise-driven discriminators."""
        self.sync_host_state()
        s = self.state
        s.code_phase[slot] = code_phase_samples % self.samples_per_prn
        s.doppler[slot] = doppler_hz
        s.ema_err[slot] = 0.0
        s.ema_err_sq[slot] = 0.0
        s.ema_quality[slot] = 0.0
        s.step_count[slot] = 0
        s.lost[slot] = False

    @property
    def active_slots(self) -> list[int]:
        return [i for i, p in enumerate(self.slot_prn) if p is not None]

    @property
    def free_slots(self) -> list[int]:
        return [i for i, p in enumerate(self.slot_prn) if p is None]

    @property
    def tracked_prns(self) -> list[int]:
        return [p for p in self.slot_prn if p is not None]

    # ------------------------------------------------------------ processing

    def _device_replicas(self, prn_idx: np.ndarray) -> torch.Tensor:
        """Replica rows for the current slot->PRN binding on the device
        (uploaded again only when assignments change)."""
        key = prn_idx.tobytes()
        if self._replica_cache[0] != key:
            rows = torch.from_numpy(self._replicas_wide[prn_idx]).to(self.device)
            self._replica_cache = (key, rows)
        return self._replica_cache[1]

    def _to_device(self, samples_block) -> torch.Tensor:
        """[B, L] complex or [B, L, 2] planes (float or raw integer words,
        dequantized on the device) as a tensor on the bank's device."""
        if isinstance(samples_block, torch.Tensor):
            return samples_block.to(self.device)
        arr = np.ascontiguousarray(samples_block)
        if np.iscomplexobj(arr):
            arr = arr.astype(np.complex64, copy=False)
        return torch.from_numpy(arr).to(self.device)

    def dispatch_block(self, samples_block, block_start_time: float) -> None:
        """Submit one block to the device WITHOUT waiting for results.

        The carry chains on the device from the previous dispatch (no host
        round trip unless an edit intervened). Collect results in dispatch
        order with collect_block()."""
        with spans.span("bank.dispatch"):
            prn_idx = np.array(
                [self._prn_row[p] if p is not None else 0 for p in self.slot_prn],
                dtype=np.int64,
            )
            replicas = self._device_replicas(prn_idx)
            state_in = self._device_state if self._device_state is not None else self.state
            samples = self._to_device(samples_block)
            new_state, outs = self._fn.packed(state_in, samples, replicas)
            self._device_state = new_state
            ready = None
            if outs.is_cuda:
                # The block's one device->host copy starts now, into pinned
                # memory, with an event behind it: collecting this block then
                # waits for its own copy only, not for blocks dispatched later.
                host = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
                host.copy_(outs, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
                outs = host
            self._pending.append(
                _Dispatched(outs, ready, samples.shape[0], block_start_time, list(self.slot_prn),
                            new_state.doppler)
            )

    @property
    def pending_blocks(self) -> int:
        return len(self._pending)

    @property
    def pending_ms(self) -> int:
        """Milliseconds of signal dispatched but not yet collected: the
        staleness any host edit of the carry suffers before taking effect."""
        return sum(p.n_ms for p in self._pending)

    def collect_block(self) -> tuple[float, int, list[ChannelObservation]]:
        """Fetch and unpack the OLDEST dispatched block. Returns
        (block_start_time, n_ms, observations); observations reflect the
        slot->PRN binding at dispatch time."""
        if not self._pending:
            raise RuntimeError("no dispatched block to collect")
        with spans.span("bank.collect"):
            pend = self._pending.pop(0)
            self._collected_doppler = pend.doppler
            if pend.ready is not None:
                with spans.span("bank.wait"):
                    pend.ready.synchronize()
            # [N_OUT, S, B] host rows, copied out of the transfer buffer so
            # the observations do not hold pinned memory.
            t = np.ascontiguousarray(pend.outs.numpy().transpose(1, 2, 0))
            outs = TrackBlockOutputs(*t[:8], t[8] > 0.5, t[9], t[10] > 0.5)
            observations = self._build_observations(outs, pend.n_ms, pend.start_time, pend.slot_prn)
            return pend.start_time, pend.n_ms, observations

    def process_block(self, samples_block, block_start_time: float) -> list[ChannelObservation]:
        """Track one [B, L] block synchronously (dispatch + collect).

        ``block_start_time`` is the receiver timestamp (s) of the block's
        first sample; pseudosymbol timestamps are code-phase corrected like
        the reference (gypsum/tracker.py:319-328)."""
        self.dispatch_block(samples_block, block_start_time)
        return self.collect_block()[2]

    def _build_observations(
        self,
        outs: TrackBlockOutputs,
        b: int,
        block_start_time: float,
        slot_prn: list[int | None],
    ) -> list[ChannelObservation]:
        observations = []
        ms = np.arange(b, dtype=np.float64) * (self.samples_per_prn / self.sample_rate)
        for slot, prn in enumerate(slot_prn):
            if prn is None:
                continue
            delay = (
                outs.code_phase[slot].astype(np.float64) / self.samples_per_prn
            ) * (self.samples_per_prn / self.sample_rate)
            starts = block_start_time + ms + delay
            ends = starts + (self.samples_per_prn / self.sample_rate)
            signs = np.sign(outs.prompt_i[slot]).astype(np.int8)
            signs[signs == 0] = 1
            prompts = (outs.prompt_i[slot] + 1j * outs.prompt_q[slot]).astype(np.complex64)
            observations.append(
                ChannelObservation(
                    prn=prn,
                    slot=slot,
                    pseudosymbol_signs=signs,
                    start_times=starts,
                    end_times=ends,
                    prompts=prompts,
                    code_phases=outs.code_phase[slot],
                    code_phases_measured=outs.code_phase_measured[slot],
                    dopplers=outs.doppler[slot],
                    carrier_phases=outs.carrier_phase[slot],
                    pll_errors=outs.pll_error[slot],
                    dll_errors=outs.dll_error[slot],
                    locked=outs.locked[slot],
                    quality=outs.quality[slot],
                    lost=bool(outs.lost[slot][-1]),
                )
            )
        return observations
