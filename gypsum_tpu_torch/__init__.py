"""gypsum_tpu_torch: the gypsum-tpu GNSS receiver (GPS L1 C/A + SBAS, GLONASS
L1OF/L2OF) on PyTorch and CUDA.

A port of the JAX package ``gypsum_tpu`` (the reference, which stays as it
is) to PyTorch, for an NVIDIA H100. It imports neither JAX nor anything of
``gypsum_tpu``: host-side modules (``nav``, ``solve``, ``signal``, ``obs``,
``io``, ``core`` config/constants/events) are copies, and the device path is
written anew:

- ``core``    : device selection (``core/device.py``), I/Q planes.
- ``ops``     : FFT correlation, and the hand-written CUDA kernels with their
                plain PyTorch twins (``ops/peak_reduce.py``, ``ops/fixup.py``,
                sources under ``csrc/``, built by ``ops/kernels.py``).
- ``acquire`` : batched acquisition over [satellite x Doppler x code phase].
- ``track``   : the two-phase block tracker and the channel bank.
- ``runtime`` : the receiver's block loop, and DualBandReceiver.
- ``cli``     : ``python -m gypsum_tpu_torch replay --file X --until-fix``
                (``--glonass-file``, ``--glonass-l2-file`` for GLONASS).

Everything that runs on a device takes ``device=`` ("cuda" by default; it
raises when no card is present instead of running on the CPU).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (``import gypsum_tpu_torch`` loads no torch)."""
    lazy = {
        "Receiver": ("gypsum_tpu_torch.runtime.receiver", "Receiver"),
        "DualBandReceiver": ("gypsum_tpu_torch.runtime.receiver", "DualBandReceiver"),
        "ReceiverConfig": ("gypsum_tpu_torch.core.config", "ReceiverConfig"),
        "AcquisitionEngine": ("gypsum_tpu_torch.acquire.engine", "AcquisitionEngine"),
        "TrackerBank": ("gypsum_tpu_torch.track.loop", "TrackerBank"),
        "WorldModel": ("gypsum_tpu_torch.solve.world", "WorldModel"),
        "FileSampleSource": ("gypsum_tpu_torch.io.sources", "FileSampleSource"),
        "ArraySampleSource": ("gypsum_tpu_torch.io.sources", "ArraySampleSource"),
        "RecordingInfo": ("gypsum_tpu_torch.io.sources", "RecordingInfo"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'gypsum_tpu_torch' has no attribute {name!r}")
