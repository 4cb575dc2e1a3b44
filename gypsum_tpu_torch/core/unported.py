"""The error raised where the port reaches a module it has not ported yet.

The host-side modules of this package are copies of the JAX package's. A
few of their code paths reach modules outside the ported slice (the
notching front end, antenna-array captures, the circulant acquisition
sweep). Those paths raise this error at the point of use
instead of doing less than the reference does.
"""

from __future__ import annotations


def unported(what: str) -> NotImplementedError:
    """The error to raise where a code path needs ``what``."""
    return NotImplementedError(
        f"{what} is not yet ported to gypsum_tpu_torch, see ROADMAP.md"
    )
