"""Multi-device scale-out on torch.distributed: the ('sat', 'time') device
mesh, sharded acquisition and tracking, streaming halos."""

from gypsum_tpu_torch.parallel.mesh import make_receiver_mesh  # noqa: F401
