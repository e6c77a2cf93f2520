"""Worker for the 2-process jax.distributed smoke test (run by
tests/test_parallel.py::test_two_process_distributed_solve).

Each process owns 2 virtual CPU devices; the coordinator stitches them into
one 4-device global mesh spanning a real process boundary — the closest
single-machine analogue of BASELINE config 5's multi-host (DCN) setup.  The
worker runs TWO phases over the global mesh:

1. the edge-sharded GN-CG pose-graph solve, checked against the
   process-local dense LM solve, and
2. (VERDICT r3 #4) the full ``DistributedSlamEngine`` SYSTEM — sharded
   keyframe bank, sharded loop search, chunked driver with mid-run GN-CG
   triggers — on a short synthetic revisit sequence, checked for decision
   and trajectory agreement with the process-local single-chip engine.

Usage: python tests/_dist_worker.py <pid> <nproc> <port>
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nislam_tpu.core.pose_graph import (  # noqa: E402
    PoseGraphProblem,
    solve_pose_graph,
)
from nislam_tpu.core.se2 import absolute_pose, relative_pose  # noqa: E402
from nislam_tpu.parallel.mesh import init_distributed, make_mesh  # noqa: E402
from nislam_tpu.parallel.solver import CGSolverConfig, solve_pose_graph_cg  # noqa: E402


def chain_problem(rng, k=24, cap=32, ecap=64):
    """Deterministic noisy odometry chain + one loop edge (same on every
    process — the map state is replicated, only the solve is sharded)."""
    gt = np.zeros((k, 3))
    for i in range(1, k):
        step = np.array([0.5, 0.1 * rng.standard_normal(), 0.1 * rng.standard_normal()])
        gt[i] = np.asarray(absolute_pose(jnp.asarray(gt[i - 1]), jnp.asarray(step)))
    fr, to, ts = [], [], []
    for i in range(1, k):
        rel = np.array(relative_pose(jnp.asarray(gt[i - 1]), jnp.asarray(gt[i])))
        rel[:2] += 0.02 * rng.standard_normal(2)
        fr.append(i - 1)
        to.append(i)
        ts.append(rel)
    fr.append(0)
    to.append(k - 1)
    ts.append(np.array(relative_pose(jnp.asarray(gt[0]), jnp.asarray(gt[k - 1]))))
    e = len(ts)
    init = np.zeros((cap, 3), np.float32)
    for i in range(1, k):
        init[i] = np.asarray(absolute_pose(jnp.asarray(init[i - 1]), jnp.asarray(ts[i - 1])))
    T = np.zeros((ecap, 3), np.float32)
    T[:e] = ts
    f_ = np.zeros(ecap, np.int32)
    t_ = np.zeros(ecap, np.int32)
    f_[:e] = fr
    t_[:e] = to
    return PoseGraphProblem(
        poses=jnp.asarray(init),
        pose_mask=jnp.arange(cap) < k,
        from_slot=jnp.asarray(f_),
        to_slot=jnp.asarray(t_),
        T=jnp.asarray(T),
        sqrt_info=jnp.broadcast_to(jnp.eye(3), (ecap, 3, 3)),
        edge_mask=jnp.arange(ecap) < e,
    )


def main() -> int:
    ndev = init_distributed(f"localhost:{port}", nproc, pid)
    assert ndev == 2 * nproc, f"global devices {ndev} != {2 * nproc}"
    assert jax.process_count() == nproc

    mesh = make_mesh({"bank": ndev})

    from jax.sharding import NamedSharding, PartitionSpec as P

    def gshard(x, spec):
        """Host-replicated numpy → global jax.Array with the given spec."""
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    rng = np.random.default_rng(0)
    prob = chain_problem(rng)
    gprob = PoseGraphProblem(
        poses=gshard(prob.poses, P()),
        pose_mask=gshard(prob.pose_mask, P()),
        from_slot=gshard(prob.from_slot, P("bank")),
        to_slot=gshard(prob.to_slot, P("bank")),
        T=gshard(prob.T, P("bank")),
        sqrt_info=gshard(prob.sqrt_info, P("bank")),
        edge_mask=gshard(prob.edge_mask, P("bank")),
    )
    cg_poses, cg_cost = solve_pose_graph_cg(
        gprob, mesh, cfg=CGSolverConfig(outer_iterations=30, cg_iterations=100)
    )
    # Replicated outputs: every process reads the scalar + its local shard.
    cg_cost = float(np.asarray(jax.device_get(cg_cost.addressable_data(0))))

    dense_poses, _, dense_cost = solve_pose_graph(prob)  # process-local
    dense_cost = float(dense_cost)
    assert cg_cost <= dense_cost * 1.05 + 1e-6, (cg_cost, dense_cost)

    local_poses = np.asarray(jax.device_get(cg_poses.addressable_data(0)))
    np.testing.assert_allclose(
        local_poses[:24], np.asarray(dense_poses[:24]), atol=2e-3
    )
    print(f"DIST_OK pid={pid} cost={cg_cost:.6f} dense={dense_cost:.6f}", flush=True)

    # --- phase 2: the distributed SLAM system across the process boundary
    slam_system_across_processes(mesh, gshard)
    print(f"DIST_SYSTEM_OK pid={pid}", flush=True)

    # --- phase 3: the FLEET engine (one sequence per device, BASELINE
    # config 4) with lanes spanning the process boundary
    fleet_across_processes(ndev)
    print(f"DIST_FLEET_OK pid={pid}", flush=True)

    # --- phase 4 (VERDICT r4 #6): checkpoint → multi-process restore —
    # a single-chip checkpoint resumes onto the cross-process mesh
    restore_across_processes(mesh, gshard)
    print(f"DIST_RESTORE_OK pid={pid}", flush=True)
    return 0


def fleet_across_processes(ndev):
    """FleetSlamEngine on a global 'data' mesh across 2 processes: each of
    the 4 lanes (2 per process) must reproduce the single-chip engine's
    run of its own sequence exactly."""
    from jax.sharding import PartitionSpec as P

    from nislam_tpu.core.config import (
        CFConfig,
        CameraConfig,
        KeyframeSelectionConfig,
        SlamConfig,
        LoopClosureConfig,
        MapConfig,
    )
    from nislam_tpu.core.slam import make_engine
    from nislam_tpu.parallel.fleet import make_fleet_engine
    from nislam_tpu.parallel.mesh import make_mesh, place_global
    from nislam_tpu.parallel.mesh import NamedSharding
    from nislam_tpu.utils.synthetic import make_world, render_sequence, straight_path

    h, w = 48, 64
    config = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=72, rotation_channel=24),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=0.08, max_angle=0.05,
            lower_response_thr=3.0, upper_response_thr=5.0,
        ),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=32, edge_capacity=64),
        loop_closure=LoopClosureConfig(to_find_loop=False),
        camera=CameraConfig(
            image_width=w, image_height=h, height=1.0,
            intrinsics=(100.0, w / 2.0, 100.0, h / 2.0),
        ),
    )
    # one deterministic sequence per lane (identical on every process)
    seqs = np.stack([
        render_sequence(
            make_world(256, 3.0, seed=10 + lane), h, w,
            straight_path(12, step=4.0, start=(128.0, 128.0)),
        )
        for lane in range(ndev)
    ])

    mesh = make_mesh({"data": ndev})
    fleet = make_fleet_engine(config, mesh)
    states = fleet.init_states()
    gimgs = place_global(
        jnp.asarray(seqs), NamedSharding(mesh, P("data"))
    )
    states, fouts = fleet.run_chunk(states, gimgs)
    states, _ = fleet.finalize(states)

    # each process checks ITS addressable lanes against a local single run
    for shard in states.bank.poses.addressable_shards:
        lane = shard.index[0].start or 0
        eng = make_engine(config)
        st = eng.init_state()
        st, outs = eng.run_chunk(st, jnp.asarray(seqs[lane]))
        st, _ = eng.finalize(st)
        n_kf = int(np.asarray(st.bank.count))
        lane_poses = np.asarray(shard.data)[0]
        np.testing.assert_allclose(
            lane_poses[:n_kf], np.asarray(st.bank.poses)[:n_kf], atol=1e-5,
            err_msg=f"lane {lane} diverged from the single-chip engine",
        )


def slam_system_across_processes(mesh, gshard):
    """Drive DistributedSlamEngine (sharded bank + sharded loop search +
    GN-CG solves) over the 2-process global mesh on a revisit loop and
    assert decision + trajectory agreement with the single-process engine."""
    import dataclasses

    from jax.sharding import PartitionSpec as P

    from nislam_tpu.core.config import (
        CFConfig,
        CameraConfig,
        KeyframeSelectionConfig,
        LoopClosureConfig,
        MapConfig,
        SlamConfig,
    )
    from nislam_tpu.core.slam import make_engine
    from nislam_tpu.parallel.engine import make_distributed_engine
    from nislam_tpu.utils.synthetic import (
        make_world,
        render_sequence,
        square_loop_path,
    )

    h, w = 48, 64
    config = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=72, rotation_channel=24),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=0.08, max_angle=0.05,
            lower_response_thr=3.0, upper_response_thr=5.0,
        ),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=64, edge_capacity=128),
        loop_closure=LoopClosureConfig(
            to_find_loop=True, position_response_thr=6.0, angle_response_thr=5.0,
            frame_gap_thr=10, distance_thr=0.5, max_candidates=32,
        ),
        camera=CameraConfig(
            image_width=w, image_height=h, height=1.0,
            intrinsics=(100.0, w / 2.0, 100.0, h / 2.0),
        ),
    )
    # identical data in every process (deterministic seed)
    world = make_world(512, 3.0, seed=5)
    frames = render_sequence(
        world, h, w, square_loop_path(8, step=5.0, start=(256.0, 256.0), tail=6)
    )

    deng = make_distributed_engine(config, mesh)
    dstate = deng.init_state()
    assert dstate.bank.fft.sharding.spec[0] == "bank"
    gframes = gshard(np.asarray(frames), P())  # replicated global array
    dstate, douts = deng.run_sequence(
        dstate, gframes, chunk_frames=8, numpy_outputs=False
    )
    dstate, _ = deng.finalize(dstate)

    def fetch(x):
        a = np.asarray(jax.device_get(x.addressable_data(0)))
        return a

    d_inserted = fetch(douts.inserted)
    d_loops = fetch(douts.loop_found)
    d_poses = fetch(dstate.bank.poses)
    assert d_inserted.shape[0] == len(frames)  # replicated outs, not a shard

    # process-local single-chip reference run on the same frames
    seng = make_engine(config)
    with jax.default_device(jax.local_devices()[0]):
        sstate = seng.init_state()
        sstate, souts = seng.run_sequence(
            sstate, jnp.asarray(frames), chunk_frames=8
        )
        sstate, _ = seng.finalize(sstate)

    np.testing.assert_array_equal(d_inserted, np.asarray(souts.inserted))
    np.testing.assert_array_equal(d_loops, np.asarray(souts.loop_found))
    assert d_loops.sum() >= 1, "revisit sequence must close a loop"
    n_kf = int(np.asarray(sstate.bank.count))
    np.testing.assert_allclose(
        d_poses[:n_kf], np.asarray(sstate.bank.poses)[:n_kf], atol=5e-3
    )


def restore_across_processes(mesh, gshard):
    """Single-chip mid-sequence checkpoint → load_state on EVERY process
    (identical host values, the multi-process placement contract) →
    DistributedSlamEngine.place() onto the cross-process mesh → continue →
    trajectory equality with the uninterrupted single-chip run."""
    import tempfile

    from jax.sharding import PartitionSpec as P

    from nislam_tpu.core.config import (
        CFConfig,
        CameraConfig,
        KeyframeSelectionConfig,
        LoopClosureConfig,
        MapConfig,
        SlamConfig,
    )
    from nislam_tpu.core.slam import init_state, make_engine
    from nislam_tpu.io.checkpoint import load_state, save_state
    from nislam_tpu.ops.registration import make_cf_ops
    from nislam_tpu.parallel.engine import make_distributed_engine
    from nislam_tpu.utils.synthetic import (
        make_world,
        render_sequence,
        square_loop_path,
    )

    h, w = 48, 64
    config = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=72, rotation_channel=24),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=0.08, max_angle=0.05,
            lower_response_thr=3.0, upper_response_thr=5.0,
        ),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=64, edge_capacity=128),
        loop_closure=LoopClosureConfig(
            to_find_loop=True, position_response_thr=6.0, angle_response_thr=5.0,
            frame_gap_thr=10, distance_thr=0.5, max_candidates=32,
        ),
        camera=CameraConfig(
            image_width=w, image_height=h, height=1.0,
            intrinsics=(100.0, w / 2.0, 100.0, h / 2.0),
        ),
    )
    world = make_world(512, 3.0, seed=5)
    frames = render_sequence(
        world, h, w, square_loop_path(8, step=5.0, start=(256.0, 256.0), tail=6)
    )
    cut = 16  # 2 aligned chunks of 8

    seng = make_engine(config)
    with jax.default_device(jax.local_devices()[0]):
        # uninterrupted reference
        s_ref = seng.init_state()
        s_ref, o_ref = seng.run_sequence(
            s_ref, jnp.asarray(frames), chunk_frames=8
        )
        s_ref, _ = seng.finalize(s_ref)
        k_ref = int(np.asarray(s_ref.bank.count))
        # first half + checkpoint (every process computes the IDENTICAL
        # state deterministically and writes its own copy)
        s_a = seng.init_state()
        s_a, _ = seng.run_sequence(
            s_a, jnp.asarray(frames[:cut]), chunk_frames=8
        )
        with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as f:
            ckpt = f.name
        save_state(ckpt, s_a)

    template = init_state(config, make_cf_ops(config.cf))
    loaded = load_state(ckpt, template)
    os.unlink(ckpt)

    deng = make_distributed_engine(config, mesh)
    dstate = deng.place(loaded)
    assert dstate.bank.fft.sharding.spec[0] == "bank"
    gframes = gshard(np.asarray(frames[cut:]), P())
    dstate, douts = deng.run_sequence(
        dstate, gframes, chunk_frames=8, numpy_outputs=False
    )
    dstate, _ = deng.finalize(dstate)

    def fetch(x):
        return np.asarray(jax.device_get(x.addressable_data(0)))

    np.testing.assert_array_equal(
        fetch(douts.inserted), np.asarray(o_ref.inserted[cut:])
    )
    np.testing.assert_array_equal(
        fetch(douts.loop_found), np.asarray(o_ref.loop_found[cut:])
    )
    np.testing.assert_allclose(
        fetch(dstate.bank.poses)[:k_ref],
        np.asarray(s_ref.bank.poses)[:k_ref],
        atol=5e-3,
    )


if __name__ == "__main__":
    sys.exit(main())
