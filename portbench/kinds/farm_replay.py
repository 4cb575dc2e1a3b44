"""Traffic kind ``farm_replay``: the replay farm, every stream slot replaying
its own capture from a pool in HBM (``traffic/farm.json``).

A thin adapter over the farm's modules: the pool from the seed
(``generator.py``), the program's farm entry driven block after block at
depth 1 (``farm.py``), and the kept blocks judged against the plain reference
(``compare.py``). ``README.md`` gives the contract every kind keeps.
"""

from __future__ import annotations

import torch

from portbench import codes, compare, farm, generator, trace

KEEP_BLOCKS = 8  # blocks of each window judged against the reference


def check(config: dict, traffic: dict) -> None:
    """Raise where the farm cannot run the cell: a band that ``codes.BANDS``
    does not hold, or a signal that its band does not have."""
    codes.band(config["band"]).code_rows(config["signals"])


class Replay:
    """The farm's system under test. Besides the kind's contract it keeps
    the farm's own objects, ``system`` (``farm.Farm``) and ``window``
    (``farm.Window``), which ``spanrun.py``, a farm-only tool, drives itself."""

    names = compare.NAMES
    block_kernel = trace.K1_KERNEL  # K1, the loop-filter fixup: once a block

    def __init__(self, cell, seed: int, device: torch.device, wrap, mark) -> None:
        self.cell, self.device = cell, device
        self.caps = generator.make_captures(cell.config, cell.traffic, seed)
        if device.type == "cuda":
            torch.cuda.init()
        mark("cuda")
        self.pool = generator.make_pool(self.caps, device)
        mark("pool")
        self.system = farm.Farm(cell.config, cell.traffic, self.caps, self.pool, device, wrap)
        self.window = farm.Window(self.system, KEEP_BLOCKS, seed)
        mark("entry")
        self.trace_span = self.caps.ring  # a traced stretch reads each ring block once
        n_streams, per = self.caps.signals.shape
        self.shape = {"block_ms": self.caps.block_ms, "channels": n_streams * per,
                      "streams": n_streams, "samples_per_ms": self.caps.samples_per_ms,
                      "k_half": cell.config["tracking"]["lag_window_half_width"]}

    def warm(self, n_blocks: int) -> None:
        self.window.warm(n_blocks)

    def run(self, seconds: float, session, traced: tuple) -> dict:
        return self.window.run(seconds, session, traced)

    def release(self) -> None:
        """Keep what the check reads; drop the program's entry and carry."""
        self.kept, self.restart_mask = self.window.kept, self.system.restart_mask
        self.system.release()
        self.window = None

    def numbers(self, raw: dict | None = None) -> dict[str, float]:
        return compare.numbers(self.cell.config, self.cell.traffic, self.caps, self.pool,
                               self.kept, self.restart_mask, self.device, raw)


setup = Replay
