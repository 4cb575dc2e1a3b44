"""Host-side navigation solution: orbits, clocks, pseudoranges, position fix."""

from gypsum_tpu_torch.solve.ephemeris import Ephemeris, ephemeris_from_subframes  # noqa: F401
from gypsum_tpu_torch.solve.world import WorldModel, ReceiverSolution  # noqa: F401
