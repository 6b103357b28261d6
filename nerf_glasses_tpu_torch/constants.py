"""Core Instant-NGP marching constants.

Semantics match the reference renderer (values are part of the snapshot /
rendering contract):
  reference: nerf_mesh_renderer/src/ngp/nerf.cuh:19-21 (grid size)
  reference: nerf_mesh_renderer/src/ngp/testbed.cu:110-186 (march constants)
  reference: nerf_mesh_renderer/src/ngp/nerf_loader.cuh:30 (NERF_SCALE)
"""

import math

# Occupancy grid: 128^3 cells per cascade, 8 cascades (mips).
NERF_GRIDSIZE = 128
NERF_CASCADES = 8

# Any alpha below this is considered invisible and culled away.
NERF_MIN_OPTICAL_THICKNESS = 0.01

# Finest number of steps per unit ray length.
NERF_STEPS = 1024
SQRT3 = math.sqrt(3.0)
STEPSIZE = SQRT3 / NERF_STEPS

MIN_CONE_STEPSIZE = STEPSIZE
# Width of the coarsest grid cell.
MAX_CONE_STEPSIZE = STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE

# dt-warp normalization (testbed.cu:220-228): dt is stored in the network
# input normalized to [0, 1] over [MIN_CONE_STEPSIZE, MIN*2^(CASCADES-1)].
MAX_WARP_STEPSIZE = MIN_CONE_STEPSIZE * (1 << (NERF_CASCADES - 1))

# Upper bound on total march iterations along one ray.
MARCH_ITER = 10000

MIN_STEPS_INBETWEEN_COMPACTION = 1
MAX_STEPS_INBETWEEN_COMPACTION = 8

# Scene scale applied when converting "nerf" (dataset) coordinates to the
# ngp unit cube (nerf_loader.cuh:30).
NERF_SCALE = 0.33

# Default render-time transmittance early-out (testbed.cuh:484).
DEFAULT_MIN_TRANSMITTANCE = 0.01

# CoherentPrime hash primes for the 3D hash grid
# (tiny-cuda-nn/encodings/grid.h:112-128; prime[0]==1 for memory coherence).
HASH_PRIMES = (1, 2654435761, 805459861)
