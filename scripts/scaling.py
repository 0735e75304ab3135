"""Scaling measurement on the virtual 8-device mesh (BASELINE.md target:
>= 80% multi-host efficiency).

Virtual CPU devices timeshare the host's cores, so a wall-clock speedup
across them is no scaling efficiency. What this script reports is only
what such a run can defensibly support:

1. **Collective audit (compiled HLO).** The data-parallel resize must
   compile with ZERO collectives touching image planes (scalar seam-count
   bookkeeping only); the column-sharded DP must execute exactly the
   row-block-halo permute count the design predicts.

2. **Work decomposition (XLA cost model).** FLOPs of the sharded
   executable vs the unsharded one: communication-free scaling means
   per-device work == total work / n_devices. efficiency_model =
   flops_unsharded / (n_devices * flops_per_device_sharded), an
   *analytic* number the compiler's own cost model certifies — the
   quantity that becomes wall-clock efficiency on real multi-device
   hardware, where interconnect transfer time (audited to be zero here
   for the data axis) is the only subtraction.

3. **Same-host walls**, reported as raw walls with the explicit caveat —
   never as an efficiency.

4. **Multi-process run (the SURVEY §4 "fake backend").** Two OS processes
   x 4 virtual CPU devices each, GLOO-backed CPU collectives, same
   sharded program — asserting the multi-HOST code path (process-spanning
   mesh, cross-process collectives) produces bit-identical seam maps.

5. **Column-sharded multi-seam resize** (extend_map_sharded — the real
   hot loop, not a one-seam demo): wall per seam + executed
   collective-permutes per seam on the 8-device mesh, bit-exact vs
   unsharded.

Run under:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

Prints one JSON line per measurement.
"""

import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _collectives(hlo_text: str) -> dict:
    out = {}
    for op in ("collective-permute", "all-reduce", "all-gather",
               "reduce-scatter", "all-to-all"):
        n = len(re.findall(rf"\b{op}", hlo_text))
        if n:
            out[op] = n
    return out


def _flops(compiled) -> float | None:
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return float(ca.get("flops", None))
    except Exception:
        return None


def _worker(proc_id: int, n_procs: int, coord: str):
    """Multi-process GLOO worker: same sharded resize across processes."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=n_procs, process_id=proc_id)
    from bench import make_test_image
    from lqr_tpu.parallel.batch import BatchCarver
    from jax.sharding import Mesh

    n_dev = len(jax.devices())
    assert n_dev == 4 * n_procs, f"expected {4 * n_procs} global devices"
    h, w, seams = 96, 128, 16
    imgs = [make_test_image(max(h, w), seed=i)[:h, :w]
            for i in range(n_dev)]
    mesh = Mesh(np.array(jax.devices()).reshape(n_dev, 1),
                ("data", "cols"))
    bc = BatchCarver(imgs, mesh=mesh)
    bc.carve(seams)
    vs = np.asarray(jax.device_get(
        jax.experimental.multihost_utils.process_allgather(bc.state.vs,
                                                           tiled=True)))
    if proc_id == 0:
        solo = BatchCarver(imgs)
        solo.carve(seams)
        ref = np.asarray(jax.device_get(solo.state.vs))
        ok = bool(np.array_equal(vs.reshape(ref.shape), ref))
        print(json.dumps({"multiproc_vs_matches_solo": ok}), flush=True)
        if not ok:
            sys.exit(3)
    sys.exit(0)


def run_multiproc() -> bool:
    """Launch 2 GLOO-backed processes running the sharded resize."""
    coord = "localhost:29411"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         str(i), "2", coord],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
        for i in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs) and \
        any('"multiproc_vs_matches_solo": true' in o for o in outs)
    return ok


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0

    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp
    from lqr_tpu import compile_cache
    compile_cache.enable()

    from bench import make_test_image
    from lqr_tpu.parallel.batch import BatchCarver, extend_map_batched
    from lqr_tpu.parallel.sharding import make_mesh, extend_map_sharded

    n_dev = len(jax.devices())
    B, h, w, seams = n_dev, 384, 512, 64
    imgs = [make_test_image(max(h, w), seed=i)[:h, :w] for i in range(B)]

    def run(mesh):
        bc = BatchCarver(imgs, mesh=mesh)
        bc.carve(seams)                      # warm/compile
        jax.block_until_ready(bc.state.depth)
        bc = BatchCarver(imgs, mesh=mesh)
        jax.block_until_ready(bc.state.ref)
        t0 = time.perf_counter()
        bc.carve(seams)
        jax.block_until_ready(bc.state.depth)
        return time.perf_counter() - t0, bc

    t_unsharded, bc_u = run(None)
    mesh = make_mesh(n_dev, data=n_dev)
    t_sharded, bc_s = run(mesh)
    assert np.array_equal(np.asarray(jax.device_get(bc_u.state.vs)),
                          np.asarray(jax.device_get(bc_s.state.vs))), \
        "sharded resize diverged"

    # compiled artifacts: collective audit + XLA cost-model decomposition
    args = (jnp.full((B,), 1, jnp.int32), None, None)
    comp_u = extend_map_batched.lower(bc_u.cfg, bc_u.state, *args).compile()
    comp_s = extend_map_batched.lower(bc_s.cfg, bc_s.state, *args).compile()
    colls = _collectives(comp_s.as_text())
    fl_u, fl_s = _flops(comp_u), _flops(comp_s)
    # cost_analysis on a sharded executable reports PER-DEVICE flops
    eff_model = (None if not fl_u or not fl_s
                 else round(fl_u / (n_dev * fl_s), 3))

    print(json.dumps({
        "metric": "data_parallel_scaling_model",
        "value": eff_model,
        "unit": "flops_unsharded / (n_devices * flops_per_device_sharded)",
        "vs_baseline": (None if eff_model is None
                        else round(eff_model / 0.8, 2)),
        "n_devices": n_dev, "images": B, "seams": seams,
        "collectives_in_compiled_loop": colls,
        "flops_unsharded": fl_u, "flops_per_device_sharded": fl_s,
        "wall_unsharded_s": round(t_unsharded, 3),
        "wall_sharded_s": round(t_sharded, 3),
        "wall_note": ("both walls timeshare the same 2-core host; they are "
                      "NOT a scaling efficiency — the model value + the "
                      "zero-collective audit are the defensible claims"),
        "bit_exact_vs_unsharded": True,
    }), flush=True)

    # multi-process GLOO (the fake-backend multi-host path)
    try:
        mp_ok = run_multiproc()
    except Exception as e:                    # noqa: BLE001
        mp_ok = f"error: {e}"
    print(json.dumps({
        "metric": "multiprocess_gloo_resize",
        "value": bool(mp_ok is True),
        "unit": "vs_map_bit_equal_across_2_processes",
        "vs_baseline": None,
        "processes": 2, "devices_per_process": 4,
        "detail": mp_ok if mp_ok is not True else "ok",
    }), flush=True)

    # column-sharded MULTI-SEAM resize (extend_map_sharded): wall +
    # executed permutes per seam
    from lqr_tpu.parallel.sharding import shard_batch_state, _block_rows
    cmesh = make_mesh(n_dev, data=1)
    n_cols = cmesh.shape["cols"]
    cseams = 16
    cimgs = [make_test_image(512, seed=50 + i)[:384, :512]
             for i in range(2)]
    solo = BatchCarver(cimgs)
    solo.carve(cseams)
    shd = BatchCarver(cimgs, mesh=cmesh)
    assert shd.col_sharded
    shd.carve(cseams)                         # warm/compile
    jax.block_until_ready(shd.state.depth)
    assert np.array_equal(np.asarray(jax.device_get(solo.state.vs)),
                          np.asarray(jax.device_get(shd.state.vs))), \
        "column-sharded resize diverged"
    shd2 = BatchCarver(cimgs, mesh=cmesh)
    jax.block_until_ready(shd2.state.ref)
    t0 = time.perf_counter()
    shd2.carve(cseams)
    jax.block_until_ready(shd2.state.depth)
    t_cs = time.perf_counter() - t0

    comp_cs = extend_map_sharded.lower(
        cmesh, shd2.cfg, shd2.state,
        jnp.full((2,), cseams, jnp.int32)).compile()
    colls_cs = _collectives(comp_cs.as_text())
    R = _block_rows(384, 1, 512 // n_cols)
    static_p = colls_cs.get("collective-permute", 0)
    # r5 layout (_carve_seam_local): exactly 2 static permutes live in the
    # per-block DP scan (executed H/R times per seam); every other static
    # permute (energy halo pair + compact carry) executes once per seam
    executed = 2 * (384 // R) + max(static_p - 2, 0)
    print(json.dumps({
        "metric": "column_sharded_multiseam_resize",
        "value": round(t_cs / cseams * 1e3, 3),
        "unit": "ms_per_seam_wall_8dev_virtual",
        "vs_baseline": None,
        "seams": cseams, "images": 2, "size": "512x384",
        "n_cols": n_cols, "block_rows": R,
        "permutes_in_compiled_body": static_p,
        "collective_permutes_executed_per_seam": executed,
        "per_row_design_executed": 2 * (384 - 1),
        "reduction_x": round(2 * 383 / max(executed, 1), 1),
        "bit_exact_vs_unsharded": True,
        "wall_s": round(t_cs, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
