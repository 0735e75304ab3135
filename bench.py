"""Benchmark: seams/s at 2048x2048, 100-seam removal (BASELINE.md), on a GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "seams/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

- value: seams/s of the engine's resize loop (``extend_map``) on the first
  device, from the median of a few timed calls that each end in
  ``block_until_ready``; the first call compiles and is not timed.
- vs_baseline: ratio to the single-core C++ reference carver
  (native/lqr_ref.cpp — the liblqr stand-in; see SPEC.md).
- bit_exact_vs_ref: the first --check-seams seams' visibility map against
  the C++ reference, bit for bit. A mismatch exits 1.

Without a GPU it prints an error and exits 2: a CPU number is never
reported as a device number.

Usage: python bench.py [--size 2048] [--seams 100] [--ref-seams 12]
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np


def make_test_image(n: int, seed: int = 0) -> np.ndarray:
    """Smooth structured test image (pure noise has degenerate seams)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, n, 3)).astype(np.float32)
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 0) + np.roll(img, -1, 1)) / 5.0
    yy, xx = np.mgrid[0:n, 0:n]
    img[:, :, 0] += 60 * np.sin(xx / 37.0) + 40 * np.cos(yy / 53.0)
    img[:, :, 1] += 50 * np.cos((xx + yy) / 41.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def check_two_axis(m: int = 768) -> bool:
    """The full two-axis protocol of benchmark config #3 at m^2 — width
    enlargement map -> materialize at 150% -> transpose -> height carve
    -> materialize -> transpose back — byte for byte against the native
    reference, through the public Carver."""
    from lqr_tpu import Carver, native

    small = make_test_image(m)
    cs = Carver(small)
    cs.resize(int(m * 1.5), m - 48)
    vs_w = native.carve(small, m // 2)
    wide = native.materialize(small, vs_w, int(m * 1.5))
    tw = np.ascontiguousarray(np.swapaxes(wide, 0, 1))
    vs_h = native.carve(tw, 48)
    out_cpu = np.swapaxes(native.materialize(tw, vs_h, m - 48), 0, 1)
    return bool(np.array_equal(cs.get_image(), out_cpu))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--seams", type=int, default=100)
    ap.add_argument("--ref-seams", type=int, default=12,
                    help="seams timed on the single-core C++ baseline "
                         "(scaled; full 100 would take minutes)")
    ap.add_argument("--check-seams", type=int, default=6,
                    help="seams cross-checked bit-exact vs the C++ ref")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    from lqr_tpu import compile_cache, native
    from lqr_tpu.core.state import EngineConfig, init_state, round_up
    from lqr_tpu.core.engine import extend_map
    from lqr_tpu.profiling import seam_roofline
    compile_cache.enable()

    n = args.size
    img = make_test_image(n)
    cfg = EngineConfig(H=n, Wb=round_up(n, 128), C=3)

    cpu_sps = args.ref_seams / native.bench(img, args.ref_seams)

    vs_dev = np.asarray(extend_map(cfg, init_state(cfg, img),
                                   jnp.int32(args.check_seams)).vs)[:, :n]
    exact = bool(np.array_equal(vs_dev, native.carve(img,
                                                     args.check_seams)))

    def one():
        st = jax.block_until_ready(init_state(cfg, img))
        t0 = time.perf_counter()
        jax.block_until_ready(extend_map(cfg, st, jnp.int32(args.seams)))
        return time.perf_counter() - t0

    t_compile = one()
    t = statistics.median(one() for _ in range(args.reps))
    dev_sps = args.seams / t
    rf = seam_roofline(n, n, device_kind=dev.device_kind)
    print(json.dumps({
        "metric": f"seams_per_sec_{n}x{n}_remove{args.seams}",
        "value": dev_sps,
        "unit": "seams/s",
        "vs_baseline": dev_sps / cpu_sps,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "bit_exact_vs_ref": exact,
        "cpu_singlecore_seams_per_sec": cpu_sps,
        "roofline_frac": dev_sps / rf.sol_seams_per_s,
        "per_seam_us": t / args.seams * 1e6,
        "first_call_s": t_compile,
    }))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
