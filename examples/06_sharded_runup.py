"""Multi-device domain decomposition: the 3-D dam break sharded along x over
a jax.sharding Mesh with ppermute halo exchange (SURVEY §2.8 — first-class
here, hooks-only in the reference).

Runs on every device JAX sees (the GPUs of the host).  ``--cpu`` runs it on
8 virtual CPU devices instead."""
import os
import sys

if "--cpu" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

from dualsphysics_multilayer.parallel.sharding import dryrun

dryrun(len(jax.devices()))
print("sharded step OK on", len(jax.devices()), "devices")
