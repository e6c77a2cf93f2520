"""nislam_tpu — a JAX non-iterative SLAM framework.

A from-scratch JAX/XLA re-design of the capabilities of the
sair-lab/ni-slam reference (monocular downward-facing ground-texture SLAM
with Kernel Cross-Correlator registration, correlation-based loop closure,
2D pose-graph optimization and occupancy-map stitching).

Layering (bottom → top), mirroring the reference layer map
(/root/reference — see SURVEY.md §1) but re-architected for an accelerator:

- ``ops``      — spectral/warp/registration primitives (XLA)
- ``core``     — SE(2) algebra, camera model, SLAM state machine,
                 loop closure, pose-graph solver, map stitcher
- ``models``   — composed model families (VO, full SLAM, registration)
- ``parallel`` — device meshes, sharded keyframe banks, distributed solvers
- ``io``       — configs, datasets, trajectories, visualization
- ``utils``    — profiling and misc helpers
"""

__version__ = "0.1.0"

from nislam_tpu.core.config import (  # noqa: F401
    CFConfig,
    CameraConfig,
    KeyframeSelectionConfig,
    LoopClosureConfig,
    MapConfig,
    MapStitcherConfig,
    SlamConfig,
    load_config,
)
