"""The control of the correctness check: the reference put in the
program's place, computed one precision below the configuration's.

The configuration states bf16 phase-1 operands with float32 results; the
control rounds them to fp8 (e4m3) instead, the step a later change might
take. Its outputs have to come out as not correct. It is not part of a
benchmark run: ``calibrate.py`` reads it on the card and
``tests/test_portbench_checks.py`` holds it at a small size.
"""

from __future__ import annotations

import torch

from portbench import compare, generator


def fp8_entry(config: dict, caps: generator.Captures, track_state):
    """``wrap`` for ``farm.Farm``: an entry with the farm's contract (state,
    block [B, N, L, 2], replicas) -> (state', outputs [B, N_OUT, S]) that is
    the reference at fp8 operands (its own replicas; the program's are not
    read)."""
    ref = compare.reference_module(config)

    def wrap(_packed):
        reps = {}

        def entry(state, samples, _replicas):
            dev = samples.device
            if dev not in reps:
                reps[dev] = ref.channel_replicas(config, caps.signals, dev)
            carry = {f: getattr(state, f) for f in generator.STATE_FIELDS}
            [(fin, outs)] = ref.track_blocks(
                config, [{"samples": samples, "carry": carry, "replicas": reps[dev]}], "fp8")
            new = track_state(
                code_phase=fin["code_phase"], carrier_phase=fin["carrier_phase"],
                doppler=fin["doppler"], carrier_offset=state.carrier_offset,
                ema_err=fin["ema_err"], ema_err_sq=fin["ema_err_sq"],
                ema_quality=fin["ema_quality"], step_count=fin["step_count"].to(torch.int32),
                lost=fin["lost"].to(torch.bool))
            return new, outs.contiguous()

        return entry

    return wrap

