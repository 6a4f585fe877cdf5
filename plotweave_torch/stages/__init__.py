"""The port's 14 pipeline stages.

Stages 01–04 are the port's own (02 runs the raster chain on the raster
device, 03 and 04 take its blob); 05–14 are copies of the JAX package's host
stages over the port's copies of ``vector``, ``stream``, ``viz`` and the
native library, with the JAX device planner and refiner left out (07 and 12
run the host paths at every size) and stage 08's fallback thinner on the
port's ``ops.thinning.zhang_suen``.
"""
