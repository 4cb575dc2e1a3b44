"""On the card: the pool's synthesis kernel against its plain version.

    python3 -m pytest portbench/tests -m card
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import generator, native

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("config", ["gps_l1ca_2046k", "glonass_l1of_4092k"])
def test_synthesis_kernel_matches_plain(card, config):
    """A pool of three short captures made by the kernel equals, word for
    word, the plain arithmetic on the card but for rare 1-LSB roundings
    (float32 sine, cosine and log of two implementations)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    cfg.update(streams=3)
    traffic = json.loads((ROOT / "portbench" / "traffic" / "farm.json").read_text())
    traffic["capture_s"] = 3
    caps = generator.make_captures(cfg, traffic, 2**31 + 77)
    pool = native.synthesize_pool(caps, card)
    for n in range(3):
        plain = generator.synth_plain(caps, n, 0, caps.capture_ms, device=card)
        for j in range(caps.ring):
            t0 = ((j + int(caps.stagger[n])) % caps.ring) * caps.block_ms
            got = pool[j, :, n].to(torch.int16)
            want = plain[t0:t0 + caps.block_ms].to(torch.int16)
            diff = (got - want).abs()
            assert int(diff.max()) <= 1
            assert float((diff > 0).float().mean()) < 1e-4
