"""All five BASELINE.json benchmark configs on a GPU, one JSON line each.

Configs (BASELINE.json "configs"):
  1. 512x384 RGB, default params, remove 100 vertical seams
  2. 1024x768 with preservation + discard bias masks and rigidity
  3. 2048x2048 two-axis rescale with seam insertion to 150% width
  4. Batched throughput: 4096x 1MP images, 25% width reduction
  5. GAP animation: 300-frame keyframed sequence with per-frame seam maps

Every timed region ends in ``jax.block_until_ready``; the first call of
each shape compiles and is not timed. Every line names the device it ran
on. Without a GPU the script exits 2 before measuring anything.

Usage: python scripts/bench_all.py [--quick] [--config N]
  --quick samples config #4 (256 images instead of 4096)
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import check_two_axis, make_test_image  # noqa: E402


def _emit(payload):
    print(json.dumps(payload), flush=True)


def _rate(cfg, st, extend_map, n_seams=100, reps=5):
    """Seams/s of one extend_map call on a prepared state (median of
    reps, after one compiling call)."""
    import jax
    import jax.numpy as jnp

    def one():
        t0 = time.perf_counter()
        jax.block_until_ready(extend_map(cfg, st, jnp.int32(n_seams)))
        return time.perf_counter() - t0

    one()
    return n_seams / statistics.median(one() for _ in range(reps))


def config1(report):
    """512x384 defaults, 100 vertical seams (liblqr defaults, CPU ref)."""
    import jax
    import jax.numpy as jnp
    from lqr_tpu.core.state import EngineConfig, init_state, round_up
    from lqr_tpu.core.engine import extend_map
    from lqr_tpu.profiling import seam_roofline
    from lqr_tpu import native

    h, w, seams = 384, 512, 100
    img = make_test_image(max(h, w))[:h, :w]
    cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3)
    st = jax.block_until_ready(init_state(cfg, img))
    out = extend_map(cfg, st, jnp.int32(seams))
    exact = bool(np.array_equal(np.asarray(out.vs)[:, :w],
                                native.carve(img, seams)))
    sps = _rate(cfg, st, extend_map, seams)
    cpu = seams / native.bench(img, seams)
    rf = seam_roofline(h, w)
    report("cfg1_512x384_default_100seams", sps, "seams/s", sps / cpu,
           bit_exact=exact, roofline_frac=sps / rf.sol_seams_per_s)


def config2(report):
    """1024x768 with pres+disc masks and rigidity (feature-mask path)."""
    import jax
    import jax.numpy as jnp
    from lqr_tpu.core.state import EngineConfig, init_state, round_up
    from lqr_tpu.core.engine import extend_map
    from lqr_tpu.profiling import seam_roofline
    from lqr_tpu import native

    h, w, seams = 768, 1024, 100
    rng = np.random.default_rng(3)
    bias = np.zeros((h, w), np.float32)
    bias[h // 4:h // 2, w // 4:w // 2] += 1.0    # preservation area
    bias[h // 2:, w // 2:] -= 0.8                # discard area
    rig = np.zeros((h, w), np.float32)
    rig[:, :w // 3] = 100.0 * rng.random((h, w // 3)).astype(np.float32)

    img = make_test_image(max(h, w))[:h, :w]
    cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3, has_bias=True,
                       has_rig=True)
    st = jax.block_until_ready(init_state(cfg, img, bias=bias, rig=rig))
    out = extend_map(cfg, st, jnp.int32(seams))
    exact = bool(np.array_equal(np.asarray(out.vs)[:, :w],
                                native.carve(img, seams, bias=bias,
                                             rig=rig)))
    sps = _rate(cfg, st, extend_map, seams)
    cpu = 12 / native.bench(img, 12)
    rf = seam_roofline(h, w, True, True)
    report("cfg2_1024x768_masks_rigidity_100seams", sps, "seams/s",
           sps / cpu, bit_exact=exact, roofline_frac=sps / rf.sol_seams_per_s)


def config3(report):
    """2048^2 two-axis rescale with insertion to 150% width.

    The CPU baseline is measured on a few seams at each of the two
    geometries the flow visits (2048x2048 width map; 3072x2048-transposed
    height map) and scaled by the config's seam counts — per-seam DP cost
    depends on geometry, not content. Bit-exactness: the full two-axis
    protocol at 768^2 (``check_two_axis``), and the width map's first
    seams at 2048^2."""
    import jax
    import jax.numpy as jnp
    from lqr_tpu import Carver, native
    from lqr_tpu.core.state import EngineConfig, init_state, round_up
    from lqr_tpu.core.engine import extend_map

    n = 2048
    img = make_test_image(n)

    def flow():
        cc = Carver(img)
        jax.block_until_ready(cc._ref_img)
        t0 = time.perf_counter()
        cc.resize(int(n * 1.5), n - 100)
        out = jax.block_until_ready(cc.get_image_device())
        return time.perf_counter() - t0, out

    flow()                                           # compile
    dt = min(flow()[0] for _ in range(2))
    out = flow()[1]
    assert out.shape == (n - 100, int(n * 1.5), 3)
    seam_ops = n // 2 + 100      # 1024 inserted width seams + 100 rows

    k = 8
    t_w = native.bench(img, k)
    tall = np.ascontiguousarray(
        np.swapaxes(np.concatenate([img, img[:, :n // 2]], axis=1), 0, 1))
    t_h = native.bench(tall, k)
    cpu_dt = t_w / k * (n // 2) + t_h / k * 100

    exact_small = check_two_axis()
    cfg = EngineConfig(H=n, Wb=round_up(n, 128), C=3)
    stc = extend_map(cfg, init_state(cfg, img), jnp.int32(6))
    exact_big = bool(np.array_equal(np.asarray(stc.vs)[:, :n],
                                    native.carve(img, 6)))
    report("cfg3_2048sq_two_axis_enlarge150", seam_ops / dt, "seam_ops/s",
           cpu_dt / dt, bit_exact=bool(exact_small and exact_big),
           wall_s=dt, cpu_single_core_wall_s=cpu_dt,
           cpu_baseline_scaled_from_seams=k,
           bit_exact_full_protocol_768=exact_small,
           bit_exact_2048_spot=exact_big)


def config4(report, n_images=4096, wave=256, seams=256):
    """Batched throughput: 1MP images, 25% width reduction (1024->768),
    in waves of ``wave`` images staged by the native codec."""
    import jax
    from lqr_tpu.parallel.batch import BatchCarver
    from lqr_tpu.utils import codec
    from lqr_tpu import native

    def stage(seed, B):
        r = np.random.default_rng(seed)
        base = make_test_image(1024, seed=seed)
        dys = r.integers(0, 64, B).astype(np.int32)
        dxs = r.integers(0, 64, B).astype(np.int32)
        arr = codec.stage_wave(base, dys, dxs, 1024, 1024)
        return arr, BatchCarver(arr)

    _, bc = stage(10_000, wave)                       # compile
    jax.block_until_ready(bc.carve(seams).state.vs)

    frs0, bc0 = stage(0, 4)
    bc0.carve(seams)
    exact = bool(np.array_equal(np.asarray(bc0.state.vs)[1, :, :1024],
                                native.carve(frs0[1], seams)))

    waves = max(1, n_images // wave)
    carve_s = 0.0
    t_all = time.perf_counter()
    for wv in range(waves):
        _, bc = stage(wv, wave)
        jax.block_until_ready(bc.state.ref)
        t0 = time.perf_counter()
        jax.block_until_ready(bc.carve(seams).state.vs)
        carve_s += time.perf_counter() - t0
    wall = time.perf_counter() - t_all
    done = waves * wave

    cpu_rate = seams / native.bench(frs0[1], seams)
    rate = done * seams / carve_s
    report("cfg4_batched_1MP_25pct_reduction", rate, "img_seams/s",
           rate / cpu_rate, bit_exact=exact, images=done,
           images_per_s_device=done / carve_s, carve_s=carve_s,
           end_to_end_wall_s=wall, cpu_single_core_img_seams_per_s=cpu_rate)


def config5(report, n_frames=300):
    """GAP animation: 300-frame keyframed schedule, per-frame seam maps."""
    import jax
    import jax.numpy as jnp
    from lqr_tpu.config import LqrConfig
    from lqr_tpu.gap import schedule
    from lqr_tpu.parallel.batch import BatchCarver, materialize_batched
    from lqr_tpu.utils import codec
    from lqr_tpu import native

    h, w = 360, 640
    base = make_test_image(max(h, w))[:h, :w]
    ii = np.arange(n_frames, dtype=np.int32)
    frames = codec.stage_wave(base, ii, 2 * ii, h, w)    # [N, h, w, 3]
    cfg_from = LqrConfig(new_width=w, new_height=h)       # identity
    cfg_to = LqrConfig(new_width=w - 160, new_height=h)   # -160 seams
    widths = np.asarray([c.new_width for c in
                         schedule(cfg_from, cfg_to, n_frames)], np.int32)
    seam_counts = (w - widths).astype(np.int32)

    def run(frs, counts):
        """Returns (stage_s, carve_s, mat_s) of one full pass."""
        t0 = time.perf_counter()
        bc = BatchCarver(frs)
        jax.block_until_ready(bc.state.ref)
        t1 = time.perf_counter()
        jax.block_until_ready(bc.carve(counts).state.vs)
        t2 = time.perf_counter()
        jax.block_until_ready(materialize_batched(
            bc.cfg, bc.state, jnp.asarray(w - counts), bc.cfg.Wb))
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2

    run(frames, seam_counts)                              # compile
    stage_s, carve_s, mat_s = run(frames, seam_counts)
    dt = stage_s + carve_s + mat_s

    probe = int(seam_counts[-1])                  # deepest frame
    cpu_total = (native.bench(frames[-1], probe) / probe
                 * float(seam_counts.sum()))
    bc = BatchCarver([frames[-1]])
    bc.carve(np.asarray([probe], np.int32))
    exact = bool(np.array_equal(np.asarray(bc.state.vs)[0, :, :w],
                                native.carve(frames[-1], probe)))
    carve_rate = float(seam_counts.sum()) / carve_s
    cpu_rate = float(seam_counts.sum()) / cpu_total
    report("cfg5_gap_300frames_keyframed", carve_rate, "img_seams/s",
           carve_rate / cpu_rate, bit_exact=exact,
           total_seams=int(seam_counts.sum()),
           frames_per_s_end_to_end=n_frames / dt, end_to_end_wall_s=dt,
           stage_s=stage_s, carve_s=carve_s, materialize_s=mat_s,
           cpu_single_core_wall_s=cpu_total)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0,
                    help="run only config N (1-5); 0 = all")
    ap.add_argument("--quick", action="store_true",
                    help="sample config #4 at 256 images")
    args = ap.parse_args()

    import jax
    from lqr_tpu import compile_cache
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_all.py: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def report(metric, value, unit, vs_baseline, **extra):
        _emit({"metric": metric, "value": float(value), "unit": unit,
               "vs_baseline": float(vs_baseline), "device": device,
               **extra})

    cfgs = {1: config1, 2: config2, 3: config3,
            4: (lambda r: config4(r, n_images=256 if args.quick else 4096)),
            5: config5}
    for i in [args.config] if args.config else [1, 2, 3, 4, 5]:
        t0 = time.perf_counter()
        cfgs[i](report)
        sys.stderr.write(
            f"[bench_all] config{i}: {time.perf_counter() - t0:.1f}s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
