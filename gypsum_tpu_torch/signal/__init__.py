"""Reference signals: C/A PRN codes, replica resampling, synthetic IQ generation."""

from gypsum_tpu_torch.signal.prn import (  # noqa: F401
    ALL_PRN_IDS,
    ca_code,
    ca_code_table,
    replica_table,
    sampled_replica,
)
