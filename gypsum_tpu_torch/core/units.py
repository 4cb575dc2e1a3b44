"""Semantic type aliases (unit newtypes).

Reference parity: gypsum/units.py. Port of gypsum_tpu/core/units.py. These
are documentation-grade aliases; they carry no runtime cost and keep
signatures self-describing.
"""

from __future__ import annotations

from typing import Any

import numpy as np

Seconds = float
ReceiverTimestampSeconds = float  # seconds since the sample stream started
GpsTimeOfWeekSeconds = float
Hertz = float
DopplerShiftHz = float
SampleRateHz = float
Radians = float
Degrees = float
Meters = float
MetersPerSecond = float
SemiCircles = float
SemiCirclesPerSecond = float
SecondsPerSecond = float
Percent = float

SampleCount = int
PrnCodePhaseSamples = float  # fractional code phase, in samples of the stream
CarrierPhaseRadians = float
CorrelationStrengthRatio = float

# Array aliases (shape/meaning documented at use sites)
IqSamples = np.ndarray  # complex64[...]
CorrelationProfile = np.ndarray
ArrayLike = Any
