"""Parallel/distributed layer: meshes, batched engines, sharded search/solve.

The reference has **no** parallelism of any kind (SURVEY §2.3: one process,
one thread, visualization-only ROS).  Everything here is a first-class
addition designed against the BASELINE scaling configs:

- :mod:`nislam_tpu.parallel.mesh` — device mesh construction
- :mod:`nislam_tpu.parallel.batch` — data-parallel multi-sequence SLAM
  (BASELINE config 4: sharded batch of sequences on one host)
- :mod:`nislam_tpu.parallel.loop_search` — keyframe bank sharded across
  devices with collective argmax loop search (BASELINE config 5)
- :mod:`nislam_tpu.parallel.solver` — distributed pose-graph Gauss-Newton
  with edge-sharded matrix-free CG over ``psum`` (BASELINE config 5)
- :mod:`nislam_tpu.parallel.engine` — the two wired into a full engine:
  one SLAM instance whose bank/solve span the mesh (BASELINE config 5 as a
  running system)
"""

from nislam_tpu.parallel.mesh import make_mesh  # noqa: F401
from nislam_tpu.parallel.batch import BatchSlamEngine, make_batch_engine  # noqa: F401
from nislam_tpu.parallel.fleet import FleetSlamEngine, make_fleet_engine  # noqa: F401
from nislam_tpu.parallel.engine import (  # noqa: F401
    DistributedSlamEngine,
    make_distributed_engine,
)
