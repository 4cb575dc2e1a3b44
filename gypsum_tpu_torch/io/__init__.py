"""IQ sample sources: file-backed streaming, in-memory, synthetic, registry."""

from gypsum_tpu_torch.io.sources import (  # noqa: F401
    ArraySampleSource,
    FileSampleSource,
    RecordingInfo,
    SampleSource,
    StreamAttributes,
)
