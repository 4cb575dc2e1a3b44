"""Physical and protocol constants for GPS L1 C/A.

All values come from IS-GPS-200 (the public GPS interface spec).
Reference parity: gypsum/constants.py:7-38.
"""

# --- C/A code structure (IS-GPS-200 §3.3.2.3) ---------------------------------
# Chips per C/A PRN sequence (one full Gold code).
PRN_CHIP_COUNT: int = 1023
# The full 1023-chip PRN repeats 1000x per second (1.023 Mchip/s chipping rate).
PRN_REPETITIONS_PER_SECOND: int = 1000
CA_CHIP_RATE_HZ: float = float(PRN_CHIP_COUNT * PRN_REPETITIONS_PER_SECOND)  # 1.023e6

# --- Carrier -------------------------------------------------------------------
GPS_L1_FREQUENCY_HZ: float = 1575.42e6

# --- Navigation message (IS-GPS-200 §20.3) ------------------------------------
BITS_PER_SECOND: int = 50
PSEUDOSYMBOLS_PER_NAVIGATION_BIT: int = 20  # 20 x 1ms PRN correlations per bit
PSEUDOSYMBOLS_PER_SECOND: int = PSEUDOSYMBOLS_PER_NAVIGATION_BIT * BITS_PER_SECOND
BITS_PER_SUBFRAME: int = 300
SECONDS_PER_SUBFRAME: int = BITS_PER_SUBFRAME // BITS_PER_SECOND  # 6
WORDS_PER_SUBFRAME: int = 10
DATA_BITS_PER_WORD: int = 24
PARITY_BITS_PER_WORD: int = 6
BITS_PER_WORD: int = DATA_BITS_PER_WORD + PARITY_BITS_PER_WORD
# The 8-bit TLM preamble that starts every subframe (IS-GPS-200 Figure 20-2).
TELEMETRY_PREAMBLE_BITS: tuple[int, ...] = (1, 0, 0, 0, 1, 0, 1, 1)

# --- Geometry / solver ---------------------------------------------------------
MINIMUM_SATELLITES_FOR_POSITION_FIX: int = 4
# WGS84 speed of light in vacuum, per IS-GPS-200 §30.3.4.3.
SPEED_OF_LIGHT_M_PER_S: float = 2.99792458e8
# WGS84 earth gravitational parameter (mu), IS-GPS-200 Table 20-IV.
EARTH_GRAVITATIONAL_PARAM: float = 3.986005e14
# WGS84 earth rotation rate (rad/s), IS-GPS-200 Table 20-IV.
EARTH_ROTATION_RATE_RAD_PER_S: float = 7.2921151467e-5
# Relativistic clock correction constant F = -2*sqrt(mu)/c^2 (s/sqrt(m)).
RELATIVISTIC_CLOCK_CORRECTION_F: float = -4.442807633e-10
# The ICD's own value of pi, used for semicircle->radian conversions
# (IS-GPS-200 §20.3.3.4.3: "the sensitivity of the results to pi").
GPS_PI: float = 3.1415926535898

# --- Time frames ---------------------------------------------------------------
# Unix epoch 1970/01/01; GPS epoch 1980/01/06 -> offset is 10 years + 7 days.
UNIX_TIMESTAMP_OF_GPS_EPOCH: float = (60 * 60 * 24) * ((365 * 10) + 7)
SECONDS_PER_WEEK: int = 60 * 60 * 24 * 7
SECONDS_PER_HALF_WEEK: int = SECONDS_PER_WEEK // 2

ONE_MILLISECOND: float = 0.001

# --- GLONASS L1OF (GLONASS ICD L1/L2 edition 5.1) ------------------------------
# The standard-precision (SP) ranging code is a single 511-chip m-sequence
# shared by every satellite; satellites are separated in FREQUENCY (FDMA),
# not by code (ICD §3.3.2.2). The code period is 1 ms — the same as GPS C/A —
# so one tracking "tick" is 1 ms for both constellations.
GLONASS_CHIP_COUNT: int = 511
GLONASS_CHIP_RATE_HZ: float = 0.511e6  # 511 kchip/s (ICD §3.3.2.2)
# L1 sub-band center: f_k = 1602 MHz + k * 562.5 kHz, k = -7..+6 (ICD §3.3.1.1;
# k >= +7 was retired in 2005 per the frequency plan).
GLONASS_L1_BASE_HZ: float = 1602.0e6
GLONASS_L1_CHANNEL_SPACING_HZ: float = 562.5e3
GLONASS_FREQUENCY_NUMBERS: tuple[int, ...] = tuple(range(-7, 7))
# L2 sub-band center: f_k = 1246 MHz + k * 437.5 kHz (ICD §3.3.1.1). The SAME
# 511-chip SP code rides both bands, so an L2OF channel needs no new code
# family — only its own front end. f_L2 / f_L1 = 7/9 exactly for every k.
GLONASS_L2_BASE_HZ: float = 1246.0e6
GLONASS_L2_CHANNEL_SPACING_HZ: float = 437.5e3
# Navigation message: 50 bps data XOR'd with a 100 Hz meander sequence ->
# 100 symbols/s line code; 85-bit strings every 2 s, the last 0.3 s of each
# string being a fixed 30-symbol time mark (ICD §4.3).
GLONASS_SYMBOLS_PER_SECOND: int = 100
GLONASS_PSEUDOSYMBOLS_PER_SYMBOL: int = 10  # 10 x 1 ms PRN periods per symbol
GLONASS_STRING_SECONDS: float = 2.0
GLONASS_STRINGS_PER_FRAME: int = 15
GLONASS_FRAME_SECONDS: float = 30.0

# --- PZ-90.11 geodetic constants (GLONASS ICD Appendix J) ----------------------
# PZ-90.11 and WGS84 agree to centimeters; positions are treated as ECEF/WGS84
# downstream. The orbit integrator (solve/glonass.py) uses these values.
PZ90_MU: float = 398600.4418e9  # m^3/s^2
PZ90_EARTH_RADIUS_M: float = 6378136.0
PZ90_J2: float = 1082.62575e-6  # second zonal harmonic (= -C20)
PZ90_EARTH_ROTATION_RATE_RAD_PER_S: float = 7.292115e-5
