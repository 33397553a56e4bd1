"""Detector geometry constants and algorithm defaults.

Eiger 2 XE module layout mirrors the reference's constants
(reference: h5read/include/eiger2xe.h:1-25).  Dispersion defaults mirror the
reference kernel-launch defaults (reference: spotfinder/spotfinder.cuh:18-32,
include/device_common.cuh:27-28).
"""

# Eiger 2 XE module dimensions (pixels)
E2XE_MOD_FAST = 1028
E2XE_MOD_SLOW = 512
E2XE_GAP_FAST = 12
E2XE_GAP_SLOW = 38

# Eiger 2 XE 16M detector: 4 x 8 modules
E2XE_16M_SLOW = 4362
E2XE_16M_FAST = 4148
E2XE_16M_NSLOW = 8
E2XE_16M_NFAST = 4

# Eiger 2 XE 4M detector: 2 x 4 modules
E2XE_4M_SLOW = 2162
E2XE_4M_FAST = 2068
E2XE_4M_NSLOW = 4
E2XE_4M_NFAST = 2

# Dispersion threshold window radii (window span = 2*R + 1)
KERNEL_RADIUS = 3  # 7x7 window
KERNEL_RADIUS_EXTENDED = 5  # 11x11 window (extended second pass)
EROSION_CHEBYSHEV_DISTANCE = 2  # erosion neighbourhood (Chebyshev)

# Dispersion threshold defaults
DEFAULT_MIN_COUNT = 3
DEFAULT_NSIG_B = 6.0
DEFAULT_NSIG_S = 3.0
DEFAULT_THRESHOLD = 0.0

# Spot filtering defaults (reference: spotfinder/spotfinder.cc:324-342)
DEFAULT_MIN_SPOT_SIZE = 3
DEFAULT_MAX_PEAK_CENTROID_SEPARATION = 2.0

# DIALS summed-area-table "BIG" cutoff: pixels at or above this are excluded
# from local statistics (reference: baseline/spotfinder/standalone.cc:76).
DIALS_BIG = 1 << 24

VALID_PIXEL = 1
MASKED_PIXEL = 0
