"""Global constants.

Mirrors the reference compile-time configuration (reference: src/constants.h:4-16)
but resolution is a runtime parameter here (the engines take width/height), since
XLA specializes the compiled program per shape anyway.

The port's copy of ``cuda_pathtracer_tpu/constants.py``.
"""

WINDOW_WIDTH = 640
WINDOW_HEIGHT = 480
NR_PIXELS = WINDOW_WIDTH * WINDOW_HEIGHT

EPS = 1e-3
PI = 3.14159265358979323846

MAX_RAY_DEPTH = 32
MAX_CACHE_DEPTH = 3

# Leaf size of the bottom-level BVH builder (reference: src/bvhBuilder.h:93-97
# terminates at count <= 4). The traversal kernels are specialized on this.
BVH_LEAF_SIZE = 4

# Number of hemisphere buckets in the path-guiding radiance cache
# (reference: src/types.h:98-104).
GUIDE_BUCKETS = 8

# t value representing "no hit yet" (reference: src/types.h:267 uses 9999999).
T_MAX = 9999999.0
