"""Receiver checkpoint / resume, and loading a JAX package's checkpoint.

Port of gypsum_tpu/runtime/checkpoint.py. The reference has no persistence:
every run cold-starts from acquisition (SURVEY.md §5). Here the complete
receiver state — tracking loop filters, navigation pipelines (bit/frame
sync), the world model (ephemerides, time bases, clock slide) and the
acquisition schedule — serializes to one file, so long replays can stop and
resume mid-stream and a warmed receiver can re-lock instantly on restart.

Format: a gzip'd pickle of a versioned dict, the JAX package's format and
version. ``bank_state`` is written as host numpy (after
``TrackerBank.sync_host_state``), never as tensors, so either package can
read the blob. On load it goes back through ``convert.py:bank_from_numpy``
(which normalizes the leaves to [S] numpy in the port's dtypes and calls
``invalidate_device_state``); the device copy is made at the next dispatch.

**A checkpoint written by the JAX package** pickles objects whose classes
live in ``gypsum_tpu.*``. Unpickling it plainly would import the JAX
package. ``_PortUnpickler.find_class`` maps every ``gypsum_tpu.`` module
path to ``gypsum_tpu_torch.`` and refuses, with ``CheckpointFormatError``,
any class whose mapped module or name the port lacks, and any ``jax`` or
``jaxlib`` class; it never imports ``gypsum_tpu``. The classes such a blob
holds are the port's copies of the JAX host modules (nav/, solve/,
runtime/pipeline.py, core/config.py), whose attributes are the same, so the
objects load as they are:

- ``_ChannelPipeline`` (runtime/pipeline.py), ``WorldModel``
  (solve/world.py) and ``_SatelliteRecord`` (solve/world_records.py): same
  attributes in both packages; loaded unchanged
  (tests/test_torch_checkpoint.py compares their attribute sets with
  freshly built port objects).
- ``TrackState`` (track/loop.py): same fields; the JAX bank's host leaves
  are [S] numpy after its ``sync_host_state`` but may be [S, 1] columns or
  other integer/float widths in older writers, so they are converted
  explicitly by ``bank_from_numpy`` (float32, step_count int32, lost bool,
  [S]).

A pickle can run code when it loads: load only checkpoints that this
package or the JAX package wrote.
"""

from __future__ import annotations

import gzip
import importlib
import importlib.util
import pickle
from pathlib import Path

from gypsum_tpu_torch.convert import bank_from_numpy

# The JAX package's version history (gypsum_tpu/runtime/checkpoint.py)
# holds for this format; 13 added the FDMA ghost veto's record field and
# dual-band checkpoints.
CHECKPOINT_VERSION = 13

_JAX_PACKAGE = "gypsum_tpu"
_PORT_PACKAGE = "gypsum_tpu_torch"


class CheckpointFormatError(pickle.UnpicklingError):
    """A checkpoint names a class the port cannot load without the JAX
    package (or does not have at all)."""


class _PortUnpickler(pickle.Unpickler):
    """Unpickler that reads ``gypsum_tpu.*`` classes as the port's."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in ("jax", "jaxlib"):
            raise CheckpointFormatError(
                f"checkpoint holds a JAX object ({module}.{name}); the port "
                "reads only host (numpy) state"
            )
        if root == _JAX_PACKAGE:
            mapped = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
            try:
                found = importlib.util.find_spec(mapped) is not None
            except ModuleNotFoundError:
                found = False
            if not found:
                raise CheckpointFormatError(
                    f"checkpoint class {module}.{name}: the port has no module {mapped}"
                )
            obj = getattr(importlib.import_module(mapped), name, None)
            if obj is None:
                raise CheckpointFormatError(
                    f"checkpoint class {module}.{name}: {mapped} has no {name!r}"
                )
            return obj
        return super().find_class(module, name)


def read_blob(path: str | Path) -> dict:
    """The checkpoint's dict, written by either package, version-checked."""
    with gzip.open(path, "rb") as f:
        blob = _PortUnpickler(f).load()
    if blob["version"] != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {blob['version']} != {CHECKPOINT_VERSION}"
        )
    return blob


def _band_blob(receiver) -> dict:
    """Per-band snapshot fields (everything but the shared world)."""
    if receiver.bank.pending_blocks:
        raise RuntimeError(
            f"{receiver.bank.pending_blocks} tracking block(s) still in "
            "flight; drain the pipeline before checkpointing"
        )
    receiver.bank.sync_host_state()
    return {
        # Excludes any undispatched read-ahead block (async_upload): it is
        # simply re-read after resume.
        "stream_seconds": receiver.stream_position_s,
        "bank_state": receiver.bank.state,
        "slot_prn": list(receiver.bank.slot_prn),
        "eligible_prns": set(receiver.eligible_prns),
        "pipelines": receiver.pipelines,
        "last_scan_time": receiver._last_scan_time,
        "subframe_count": receiver.subframe_count,
    }


def _restore_band(receiver, blob: dict) -> float:
    outside = [
        p for p in blob["slot_prn"]
        if p is not None and p not in receiver.bank._prn_row
    ]
    if outside:
        raise ValueError(
            f"checkpoint tracks PRN(s) {outside} outside this receiver's "
            "family — construct the Receiver with eligible_prns covering them"
        )
    bank_from_numpy(receiver.bank, blob["slot_prn"], blob["bank_state"])
    receiver.eligible_prns = blob["eligible_prns"]
    receiver.pipelines = blob["pipelines"]
    receiver._last_scan_time = blob["last_scan_time"]
    receiver.subframe_count = blob["subframe_count"]
    return float(blob["stream_seconds"])


def _write(blob: dict, path: str | Path) -> None:
    with gzip.open(path, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)


def save_checkpoint(receiver, path: str | Path) -> None:
    """Snapshot a Receiver (runtime/receiver.py) to ``path``.

    The caller must have drained the tracking pipeline (Receiver.run does);
    a checkpoint taken with blocks in flight would otherwise skip their
    samples on resume."""
    _write({"version": CHECKPOINT_VERSION, **_band_blob(receiver), "world": receiver.world}, path)


#: DualBandReceiver attribute name per band key in a dual checkpoint.
_DUAL_BANDS = ("gps", "glonass", "glonass_l2")


def save_dual_checkpoint(dual, path: str | Path) -> None:
    """Snapshot a DualBandReceiver: one per-band blob each (same contents
    as a single-band checkpoint) plus the SHARED world model exactly once
    (the bands' ``world`` references are re-tied on load)."""
    bands = {
        name: _band_blob(getattr(dual, name))
        for name in _DUAL_BANDS
        if getattr(dual, name, None) is not None
    }
    _write({"version": CHECKPOINT_VERSION, "dual_bands": bands, "world": dual.world}, path)


def load_dual_checkpoint(dual, path: str | Path) -> dict[str, float]:
    """Restore a dual checkpoint into a freshly constructed
    DualBandReceiver with the same band set. Returns the per-band stream
    positions; the caller fast-forwards each band's source."""
    blob = read_blob(path)
    if "dual_bands" not in blob:
        raise ValueError("not a dual-band checkpoint (use load_checkpoint)")
    have = {n for n in _DUAL_BANDS if getattr(dual, n, None) is not None}
    if have != set(blob["dual_bands"]):
        raise ValueError(
            f"checkpoint bands {sorted(blob['dual_bands'])} != receiver "
            f"bands {sorted(have)}"
        )
    out: dict[str, float] = {}
    for name, band_blob in blob["dual_bands"].items():
        out[name] = _restore_band(getattr(dual, name), band_blob)
    dual.world = blob["world"]
    for name in have:
        getattr(dual, name).world = blob["world"]
    return out


def load_checkpoint(receiver, path: str | Path) -> float:
    """Restore a snapshot (written by either package) into a freshly
    constructed Receiver whose source is positioned at (or seekable to) the
    checkpoint's stream position.

    Returns the stream timestamp the checkpoint was taken at; the caller is
    responsible for fast-forwarding the sample source to it (sources are
    sequential, matching the reference's cursor model).
    """
    blob = read_blob(path)
    if "dual_bands" in blob:
        raise ValueError(
            "dual-band checkpoint: restore through load_dual_checkpoint"
        )
    seconds = _restore_band(receiver, blob)
    receiver.world = blob["world"]
    return seconds


def fast_forward(source, seconds: float, chunk_ms: int = 1000) -> None:
    """Advance a sequential source to ``seconds`` (whole-ms resolution)."""
    remaining_ms = int(round((seconds - source.seconds_consumed) * 1000))
    while remaining_ms > 0:
        step = min(chunk_ms, remaining_ms)
        source.read_block(step)
        remaining_ms -= step
