"""Host-side navigation message processing.

Pseudosymbols -> bits (``bits``), bits -> subframes (``frames``), subframe
bit-field parsing/encoding (``subframes``), word-level parity (``words``).
"""

from gypsum_tpu_torch.nav.bits import BitIntegrator  # noqa: F401
from gypsum_tpu_torch.nav.frames import SubframeDecoder  # noqa: F401
