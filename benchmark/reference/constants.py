"""Engine-wide constants.

Parity source: reference/ctts.h:22-38 and ctts.c:42-46.

Frozen copy of ctts_tpu_torch/constants.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

# Database format ("CTTS" little-endian; ctts.h:22-23)
MAGIC = 0x53545443
VERSION = 1

# Audio format (ctts.h:24-25)
SAMPLE_RATE = 22050
BITS_PER_SAMPLE = 16

# Maximum characters per unit (ctts.h:26)
MAX_UNIT_LEN = 16

# Default parameters (ctts.h:29-34)
DEFAULT_CROSSFADE_MS = 20.0
DEFAULT_WORD_PAUSE_MS = 120.0
DEFAULT_UNKNOWN_SILENCE_MS = 30.0
DEFAULT_FADE_IN_MS = 3.0
DEFAULT_FADE_OUT_MS = 3.0
DEFAULT_SPEED = 1.0

# Speed limits (ctts.h:37-38)
MIN_SPEED = 0.5
MAX_SPEED = 2.0

# FNV-1a hash constants (ctts.c:42-43)
FNV_OFFSET_BASIS = 2166136261
FNV_PRIME = 16777619

# Hash table load factor (ctts.c:44)
HASH_TABLE_LOAD = 0.7

# Crossfade LUT resolution (ctts.c:52)
FADE_LUT_SIZE = 1024

# Synthesis-time fixed parameters
TARGET_RMS = 3000.0         # energy normalization target (ctts.c:3684)
PITCH_FRAME_SIZE = 256      # intonation contour frame (ctts.c:2194)
WSOLA_FRAME_SIZE = 512      # time-stretch frame (ctts.c:3506)
