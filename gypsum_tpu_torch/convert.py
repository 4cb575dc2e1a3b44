"""Carrying a receiver's state across from the JAX package.

A GNSS receiver has no weights: what crosses between the two packages is
the tracking loop's carry and the bank's slot binding. The JAX bank keeps
its carry on the host as numpy arrays (``fresh_state``/``sync_host_state``
in gypsum_tpu/track/loop.py), as [S] or [S, 1] columns; these functions take
such arrays, so this module needs neither JAX nor the JAX package.

A whole receiver crosses through a checkpoint: runtime/checkpoint.py reads a
checkpoint written by the JAX package (its classes mapped to the port's,
``gypsum_tpu`` never imported) and restores its carry through
``bank_from_numpy``.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.track.loop import TrackerBank, TrackState

_DTYPES = {
    "step_count": np.int32,
    "lost": np.bool_,
}


def _host_leaves(state) -> TrackState:
    """The nine carry fields of any TrackState-like tuple as [S] numpy copies
    in the port's dtypes (float32, step_count int32, lost bool)."""
    fields = {}
    for name in TrackState._fields:
        a = np.asarray(getattr(state, name))
        fields[name] = np.array(a.reshape(-1), dtype=_DTYPES.get(name, np.float32))
    sizes = {a.shape[0] for a in fields.values()}
    if len(sizes) != 1:
        raise ValueError(f"carry fields disagree on the channel count: {sorted(sizes)}")
    return TrackState(**fields)


def track_state_from_numpy(state, device: str | torch.device = "cuda") -> TrackState:
    """A JAX TrackState with numpy leaves -> the port's TrackState of [S]
    tensors on ``device``."""
    dev = resolve_device(device)
    return TrackState(*(torch.from_numpy(a).to(dev) for a in _host_leaves(state)))


def bank_from_numpy(bank: TrackerBank, slot_prn: Sequence[int | None], state) -> TrackerBank:
    """Load a JAX bank's slot binding (``slot_prn``) and host carry
    (``state``) into the port's ``bank``; returns the bank."""
    carry = _host_leaves(state)
    if len(slot_prn) != bank.n_channels or carry.code_phase.shape[0] != bank.n_channels:
        raise ValueError(
            f"bank has {bank.n_channels} channels; got {len(slot_prn)} slots and "
            f"a carry of {carry.code_phase.shape[0]}"
        )
    unknown = {p for p in slot_prn if p is not None} - set(bank.prns)
    if unknown:
        raise ValueError(f"PRNs outside the bank's family: {sorted(unknown)}")
    if bank.pending_blocks:
        raise RuntimeError("collect the bank's dispatched blocks before loading a carry")
    bank.slot_prn = list(slot_prn)
    bank.state = carry
    bank.invalidate_device_state()
    return bank
