"""Smoke test of lqr_tpu on an NVIDIA GPU: the main path at real sizes,
every result checked bit for bit against the repository's references.

Default (one card, one process), in order:

1. device  — the card's name and power limit (nvidia-smi); no GPU, no run.
2. build   — the CUDA seam-sweep library (native/seam_sweep.cu).
3. kernel  — the sweep kernel against the scan DP (core.dp) on the same
             card: seams and the final cost row, tolerance 0.
4. solo    — ``Carver`` at 2048^2 removing 100 seams against the native
             C++ reference (map and pixels), then the two-axis 150%
             enlargement of benchmark config #3.
5. batch   — ``BatchCarver`` on 64 images of 1152x864 at 25% width
             reduction, and a ragged masked batch, against the native
             reference.
6. cli     — ``lqr_tpu.cli.main`` in-process on .ppm files.
7. timings — end-to-end ``extend_map`` seams/s with the kernel and with the
             scan DP, taking turns (kernel, scan, scan, kernel), at the
             shapes of PERF.md.

``--four`` runs only the multi-card phase on four cards: ``BatchCarver``
data-parallel over 4 cards and the column-sharded resize over cols=4, each
bitwise equal to the same job on one card.

Any failed check raises, so the script exits non-zero; the last line of
standard output is then never the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four]
"""

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def timed(fn, *args):
    """(seconds, result) of fn(*args), waiting for the device."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def check_equal(what: str, got, want) -> None:
    if not np.array_equal(_bits(got), _bits(want)):
        bad = int(np.sum(_bits(got) != _bits(want)))
        raise AssertionError(f"{what}: {bad} elements differ")


# ---------------------------------------------------------------------------
# phase 3: the sweep kernel against the scan DP on the same card
# ---------------------------------------------------------------------------

def _energy(img, nrg=0, bias=None):
    """The engine's energy (+ bias, +inf beyond the width) of an image in
    a 128-aligned buffer, as _carve_once feeds the seam search."""
    import jax.numpy as jnp
    from lqr_tpu.core.energy import energy_from_plane, reader_plane
    from lqr_tpu.core.state import round_up
    h, w = img.shape[:2]
    Wb = round_up(w, 128)
    buf = np.zeros((h, Wb, img.shape[2]), np.uint8)
    buf[:, :w] = img
    e = energy_from_plane(reader_plane(jnp.asarray(buf), nrg), w, nrg)
    if bias is not None:
        bb = np.zeros((h, Wb), np.float32)
        bb[:, :w] = bias
        lane = jnp.arange(Wb)[None, :]
        e = jnp.where(lane < w, e + bb, jnp.inf)
    return e


def _pad(a, Wb):
    out = np.zeros(a.shape[:-1] + (Wb,), np.float32)
    out[..., :a.shape[-1]] = a
    return out


def phase_kernel(make_test_image) -> int:
    import jax
    import jax.numpy as jnp
    from lqr_tpu.core import dp
    from lqr_tpu.ops import sweep
    from lqr_tpu.parallel.batch import rigc_table

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def ref(e, rig, pref, dx, has_rig, h=None, rigc=None):
        M, bp = dp.dp_forward(e, rig, pref, dx, has_rig, h=h, rigc_vec=rigc)
        return dp.backtrack(M, bp, pref), M

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def ker(e, rig, pref, dx, has_rig, h=None, rigc=None):
        return sweep.sweep(e, rig, pref, dx, has_rig, h=h, rigc_vec=rigc)

    rng = np.random.default_rng(0)
    cases = []
    img2k = make_test_image(2048)
    cases.append(("2048x2048", _energy(img2k), None, 1))
    img512 = make_test_image(512)[:384]
    rig512 = _pad(np.round(rng.random((384, 512)) * 8).astype(np.float32)
                  * 12.5, 512)
    for dx in (0, 1, 3, 10):
        cases.append((f"512x384 rig delta_x={dx}", _energy(img512), rig512,
                      dx))
    img1k = make_test_image(1024)[:768]
    bias = np.zeros((768, 1024), np.float32)
    bias[192:384, 256:512] += 1.0
    bias[384:, 512:] -= 0.8
    rig1k = np.zeros((768, 1024), np.float32)
    rig1k[:, :341] = 100.0 * rng.random((768, 341)).astype(np.float32)
    cases.append(("1024x768 bias+rig", _energy(img1k, bias=bias),
                  _pad(rig1k, 1024), 1))
    cases.append(("1024x768 sqrt energy delta_x=2", _energy(img1k, nrg=2),
                  None, 2))
    ties = np.full((300, 3072), np.inf, np.float32)
    ties[:, :3000] = np.round(rng.random((300, 3000)) * 4) / 4
    cases.append(("3000x300 in 3072 ties", jnp.asarray(ties), None, 1))
    cases.append(("3000x300 in 3072 ties rig delta_x=3", jnp.asarray(ties),
                  _pad(np.round(rng.random((300, 3000)) * 4)
                       .astype(np.float32), 3072), 3))

    n = 0
    for name, e, rig, dx in cases:
        has_rig = rig is not None
        r = jnp.asarray(rig) if has_rig else None
        for pref in (True, False):
            p = jnp.bool_(pref)
            s_ref, m_ref = ref(e, r, p, dx, has_rig)
            s_ker, m_ker = ker(e, r, p, dx, has_rig)
            check_equal(f"seam {name} pref_left={pref}", s_ker, s_ref)
            check_equal(f"M_last {name} pref_left={pref}", m_ker, m_ref)
            n += 1

    # a ragged batch: per-image heights, widths, side and rigidity
    B, H, Wb, dx = 16, 864, 1152, 2
    heights = rng.integers(200, H + 1, B).astype(np.int32)
    heights[0] = H
    eb = np.full((B, H, Wb), np.inf, np.float32)
    rb = np.zeros((B, H, Wb), np.float32)
    for i in range(B):
        w = int(rng.integers(600, Wb + 1))
        eb[i, :, :w] = np.round(rng.random((H, w)) * 16) / 16
        rb[i, :heights[i], :w] = rng.random((heights[i], w)) * 40
    prefs = rng.random(B) < 0.5
    rc = rigc_table(heights, dx)
    for has_rig in (True, False):
        args = (jnp.asarray(eb), jnp.asarray(rb), jnp.asarray(prefs))
        extra = (jnp.asarray(heights), jnp.asarray(rc))
        s_ref, m_ref = jax.vmap(
            lambda e, r, p, h, c: ref(e, r, p, dx, has_rig, h, c))(
                *args, *extra)
        s_ker, m_ker = jax.vmap(
            lambda e, r, p, h, c: ker(e, r, p, dx, has_rig, h, c))(
                *args, *extra)
        check_equal(f"ragged batch seams has_rig={has_rig}", s_ker, s_ref)
        check_equal(f"ragged batch M_last has_rig={has_rig}", m_ker, m_ref)
        n += 1
    return n


# ---------------------------------------------------------------------------
# phases 4-6: the main path through the public entry points
# ---------------------------------------------------------------------------

def phase_solo(make_test_image, check_two_axis, n=2048, seams=100):
    from lqr_tpu import Carver, native

    img = make_test_image(n)
    c = Carver(img)
    t, _ = timed(lambda: c.resize(n - seams, n) or c.get_image_device())
    vs_ref = native.carve(img, seams)
    check_equal(f"Carver {n}^2 -{seams} map", c.vmap_dump().data, vs_ref)
    check_equal(f"Carver {n}^2 -{seams} pixels", c.get_image(),
                native.materialize(img, vs_ref, n - seams))
    log(f"solo: Carver {n}x{n} resize to {n - seams}x{n} matches the "
        f"native reference (map and pixels); first call {t:.2f} s")

    c2 = Carver(img)
    t, out = timed(lambda: c2.resize(int(n * 1.5), n - seams)
                   or c2.get_image_device())
    if out.shape != (n - seams, int(n * 1.5), 3):
        raise AssertionError(f"two-axis output shape {out.shape}")
    if not check_two_axis():
        raise AssertionError("two-axis protocol at 768^2 differs from the "
                             "native reference")
    log(f"solo: two-axis {n}x{n} -> {int(n * 1.5)}x{n - seams} "
        f"(first call {t:.2f} s); full protocol at 768^2 matches native")


def phase_batch(make_test_image, B=64, H=864, W=1152, samples=(0, 37)):
    from lqr_tpu import native
    from lqr_tpu.parallel.batch import BatchCarver

    base = make_test_image(W)[:H]
    imgs = np.stack([np.roll(base, (3 * i, 7 * i), axis=(0, 1))
                     for i in range(B)])
    k = W // 4
    bc = BatchCarver(imgs)
    t, _ = timed(lambda: bc.carve(k).state.vs)
    outs = bc.images_at(W - k)
    vs = np.asarray(bc.state.vs)
    for i in samples:
        vs_ref = native.carve(imgs[i], k)
        check_equal(f"batch image {i} map", vs[i, :, :W], vs_ref)
        check_equal(f"batch image {i} pixels", outs[i],
                    native.materialize(imgs[i], vs_ref, W - k))
    log(f"batch: {B} x {W}x{H} -{k} seams (first call {t:.2f} s); images "
        f"{list(samples)} match the native reference")

    rng = np.random.default_rng(5)
    sizes = [(384, 512), (300, 480), (384, 400), (256, 512), (380, 500),
             (200, 300)]
    rimgs = [make_test_image(512, seed=10 + i)[:h, :w]
             for i, (h, w) in enumerate(sizes)]
    rigidity, dx = 40.0, 2
    biases, rigmasks = [], []
    for h, w in sizes:
        b = np.zeros((h, w), np.float32)
        b[h // 4:h // 2, w // 4:w // 2] += 1.0
        b[h // 2:, w // 2:] -= 0.8
        biases.append(b)
        rigmasks.append(rng.random((h, w)).astype(np.float32))
    counts = np.array([50, 40, 60, 30, 45, 20], np.int32)
    rb = BatchCarver(rimgs, delta_x=dx, rigidity=rigidity, biases=biases,
                     rigmasks=rigmasks)
    assert rb.ragged
    rb.carve(counts)
    rvs = np.asarray(rb.state.vs)
    for i, (h, w) in enumerate(sizes):
        ref = native.carve(rimgs[i], int(counts[i]), bias=biases[i],
                           rig=rigmasks[i] * np.float32(rigidity),
                           delta_x=dx)
        check_equal(f"ragged masked image {i}", rvs[i, :h, :w], ref)
    log(f"batch: ragged masked batch of {len(sizes)} (delta_x={dx}, bias, "
        f"rigmask) matches the native reference")


def _write_ppm(path, img):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())


def _read_ppm(path):
    data = open(path, "rb").read()
    parts = data.split(maxsplit=4)
    assert parts[0] == b"P6" and parts[3] == b"255"
    w, h = int(parts[1]), int(parts[2])
    return np.frombuffer(parts[4], np.uint8).reshape(h, w, 3)


def phase_cli(make_test_image):
    from lqr_tpu import Carver
    from lqr_tpu.cli import main as cli_main

    imgs = [make_test_image(640, seed=3)[:480],
            make_test_image(640, seed=4)[:480]]
    with tempfile.TemporaryDirectory() as d:
        ins = [os.path.join(d, f"in{i}.ppm") for i in range(2)]
        for p, im in zip(ins, imgs):
            _write_ppm(p, im)
        outdir = os.path.join(d, "out")
        os.mkdir(outdir)
        rc = cli_main(ins + ["560", "400", "--outdir", outdir])
        if rc != 0:
            raise AssertionError(f"cli returned {rc}")
        for p, im in zip(ins, imgs):
            stem = os.path.splitext(os.path.basename(p))[0]
            got = _read_ppm(os.path.join(outdir, f"{stem}_lqr.ppm"))
            c = Carver(im)
            c.resize(560, 400)
            check_equal(f"cli {os.path.basename(p)}", got, c.get_image())
    log("cli: two .ppm files resized to 560x400 in-process, equal to "
        "Carver")


# ---------------------------------------------------------------------------
# phase 7: kernel against scan DP, end to end
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def scan_dp_seam_search():
    """Route the engine's seam search to core.dp.find_seam (the scan DP)
    while a comparison run traces; kernel runs use the untouched engine."""
    from lqr_tpu.core import dp
    from lqr_tpu.core import engine as eng

    def plain(cfg, e, rig, pl, h=None, rigc_vec=None):
        return dp.find_seam(e, rig, pl, cfg.delta_x, cfg.has_rig, h=h,
                            rigc_vec=rigc_vec)

    orig = eng._find_seam
    eng._find_seam = plain
    try:
        yield
    finally:
        eng._find_seam = orig


def phase_timings(make_test_image, card, seams=100, div=1, B=64):
    """div shrinks every shape (for a rehearsal on the CPU)."""
    import jax
    import jax.numpy as jnp
    from lqr_tpu.core import engine as eng
    from lqr_tpu.core.state import EngineConfig, init_state, round_up
    from lqr_tpu.ops import sweep
    from lqr_tpu.parallel import batch as bmod

    rng = np.random.default_rng(9)

    def solo(h, w, dx=1, masks=False):
        img = make_test_image(max(h, w))[:h, :w]
        kw = {}
        if masks:
            b = np.zeros((h, w), np.float32)
            b[h // 4:h // 2, w // 4:w // 2] += 1.0
            b[h // 2:, w // 2:] -= 0.8
            r = np.zeros((h, w), np.float32)
            r[:, :w // 3] = 100.0 * rng.random((h, w // 3))
            kw = dict(bias=b, rig=r)
        cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3, delta_x=dx,
                           has_bias=masks, has_rig=masks)
        st = jax.block_until_ready(init_state(cfg, img, **kw))
        return cfg, st, eng.extend_map, eng._extend_hot, jnp.int32(seams), 1

    def batched(B, h, w):
        base = make_test_image(w)[:h]
        cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3)
        imgs = np.zeros((B, h, cfg.Wb, 3), np.uint8)
        for i in range(B):
            imgs[i, :, :w] = np.roll(base, 5 * i, axis=1)
        st = jax.block_until_ready(bmod.init_state_batched(
            cfg, imgs, np.full((B,), w, np.int32)))
        return (cfg, st, bmod.extend_map_batched,
                bmod.extend_map_batched.__wrapped__,
                jnp.full((B,), seams, jnp.int32), B)

    d = div
    shapes = [
        (f"{2048 // d}x{2048 // d} -{seams}",
         lambda: solo(2048 // d, 2048 // d)),
        (f"{512 // d}x{384 // d} -{seams}", lambda: solo(384 // d, 512 // d)),
        (f"{1024 // d}x{768 // d} bias+rig -{seams}",
         lambda: solo(768 // d, 1024 // d, masks=True)),
        (f"{B} x {1152 // d}x{864 // d} batch -{seams}",
         lambda: batched(B, 864 // d, 1152 // d)),
        (f"{2048 // d}x{2048 // d} delta_x=3 -{seams}",
         lambda: solo(2048 // d, 2048 // d, dx=3))]
    rows = []
    for name, make in shapes:
        # the kernel side is the public jitted loop (already compiled by
        # the earlier phases where the shapes agree); the scan side is a
        # fresh jit of the same body — jit caches traces per function, and
        # this one must be traced under scan_dp_seam_search
        cfg, st, kern, fn, k, n_img = make()
        plain = jax.jit(lambda c, s, n: fn(c, s, n), static_argnums=0)
        t_ck, out_k = timed(kern, cfg, st, k)
        with scan_dp_seam_search():
            t_cp, out_p = timed(plain, cfg, st, k)
            plain_hlo = plain.lower(cfg, st, k).as_text()
        on_gpu = jax.devices()[0].platform == "gpu"
        if (sweep.TARGET in kern.lower(cfg, st, k).as_text()) != on_gpu \
                or sweep.TARGET in plain_hlo:
            raise AssertionError(f"timing {name}: wrong seam search "
                                 "lowered on one side")
        check_equal(f"timing {name}: kernel vs scan DP maps", out_k.vs,
                    out_p.vs)
        tk, tp = [], []
        for order in ("kp", "pk"):          # kernel, scan, scan, kernel
            for side in order:
                if side == "k":
                    tk.append(timed(kern, cfg, st, k)[0])
                else:
                    with scan_dp_seam_search():
                        tp.append(timed(plain, cfg, st, k)[0])
        sk = seams / statistics.median(tk)
        sp = seams / statistics.median(tp)
        rows.append({"shape": name, "kernel_seams_per_s": sk,
                     "scan_seams_per_s": sp, "images": n_img,
                     "kernel_s": tk, "scan_s": tp,
                     "compile_kernel_s": t_ck, "compile_scan_s": t_cp})
        log(f"timing {name}: kernel {sk:.1f} seams/s, scan DP {sp:.1f} "
            f"seams/s ({sk / sp:.1f}x; {n_img} image(s) per seam step); "
            f"first call kernel {t_ck:.1f} s, scan DP {t_cp:.1f} s "
            f"[{card}]")
    return rows


# ---------------------------------------------------------------------------
# --four: the multi-card phase
# ---------------------------------------------------------------------------

def phase_four(make_test_image, n_dev=4, B=16, H=384, W=512, seams=100,
               col_n=2048, col_B=2, col_seams=30):
    """BatchCarver data-parallel over n_dev devices, and the column-sharded
    resize over cols=n_dev, each bitwise equal to the same job on one
    device (a one-device BatchCarver; a solo Carver per image)."""
    import jax
    from lqr_tpu import Carver
    from lqr_tpu.parallel.batch import BatchCarver
    from lqr_tpu.parallel.sharding import make_mesh

    base = make_test_image(W)[:H]
    imgs = np.stack([np.roll(base, (3 * i, 11 * i), axis=(0, 1))
                     for i in range(B)])
    one = BatchCarver(imgs)
    t1, _ = timed(lambda: one.carve(seams).state.vs)
    dp_ = BatchCarver(imgs, mesh=make_mesh(n_dev, data=n_dev))
    tn, _ = timed(lambda: dp_.carve(seams).state.vs)
    check_equal("data-parallel maps", jax.device_get(dp_.state.vs),
                jax.device_get(one.state.vs))
    log(f"four: BatchCarver {B} x {W}x{H} -{seams} over mesh "
        f"data={n_dev} equals one device (first calls: 1 device "
        f"{t1:.2f} s, {n_dev} devices {tn:.2f} s)")

    cimgs = [make_test_image(col_n, seed=20 + i) for i in range(col_B)]
    csh = BatchCarver(cimgs, mesh=make_mesh(n_dev, data=1))
    if not csh.col_sharded:
        raise AssertionError("column mesh did not select the sharded loop")
    tn, _ = timed(lambda: csh.carve(col_seams).state.vs)
    t_sh, _ = timed(lambda: csh.carve(col_seams).state.vs)
    vs = np.asarray(jax.device_get(csh.state.vs))
    for i, im in enumerate(cimgs):
        c = Carver(im)
        c.resize(col_n - 2 * col_seams, col_n)
        check_equal(f"column-sharded image {i}", vs[i, :, :col_n],
                    c.vmap_dump().data)
    log(f"four: column-sharded {col_B} x {col_n}x{col_n} -{2 * col_seams} "
        f"over mesh cols={n_dev} equals a one-device Carver per image "
        f"(first call {tn:.2f} s; second {col_seams} seams "
        f"{t_sh:.2f} s)")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 2
    cards = card_lines()
    for ln in cards[:want]:
        log(f"card: {ln}")
    card = cards[0]

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import check_two_axis, make_test_image
    from lqr_tpu import compile_cache
    from lqr_tpu.ops import sweep
    log(f"compile cache: {compile_cache.enable()}")

    t, so = timed(sweep.build)
    sweep.load()
    log(f"build: {so.name} ready in {t:.1f} s")

    if args.four:
        phase_four(make_test_image)
    else:
        t0 = time.perf_counter()
        n = phase_kernel(make_test_image)
        log(f"kernel: {n} cases bitwise equal to the scan DP "
            f"({time.perf_counter() - t0:.1f} s, compiles included)")
        phase_solo(make_test_image, check_two_axis)
        phase_batch(make_test_image)
        phase_cli(make_test_image)
        rows = phase_timings(make_test_image, card)
        log("timings: " + json.dumps(rows))

    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
