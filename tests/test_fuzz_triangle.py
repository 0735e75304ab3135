"""Property fuzz of the implementation triangle (VERDICT r1 "next" #9).

Sweeps >= 50 random configurations (size, channels, delta_x, energy,
masks, side-switch frequency, seam count) and asserts the visibility maps
are BIT-EQUAL across:

- the NumPy oracle (lqr_tpu/oracle.py),
- the single-core C++ reference (native/lqr_ref.cpp),
- the JAX engine (scan DP path),
- the column-sharded resize loop on the virtual 8-device mesh (every
  17th config).

sqrt-based energies (GRAD_NORM / LUMA_GRAD_NORM) are fuzzed as a
JAX-vs-C++ pair only: their NumPy sqrt differs by 1-2 ulp by design
(SPEC.md §2 note), which can legitimately flip ties against the oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lqr_tpu import oracle, native
from lqr_tpu.core.state import EngineConfig, init_state
from lqr_tpu.core.engine import extend_map

# small shape buckets bound the jit-compile count; ties are injected by
# quantizing pixel values
_HS = (12, 16, 24)
_EXACT_NRGS = (0, 1, 3, 4, 6)      # 3-way bit-exact families
_NORM_NRGS = (2, 5)                # sqrt family: JAX vs C++ only


def _random_case(rng, i):
    h = int(rng.choice(_HS))
    w = int(rng.integers(16, 61))
    c = int(rng.choice([1, 2, 3, 4]))
    delta_x = int(rng.integers(0, 4))
    ssf = int(rng.choice([0, 1, 2, 3]))
    nrg = int(rng.choice(_NORM_NRGS if i % 7 == 3 else _EXACT_NRGS))
    n_seams = int(rng.integers(1, min(9, w - 2)))
    levels = int(rng.choice([4, 8, 256]))   # few levels -> abundant ties
    img = (rng.integers(0, levels, (h, w, c))
           * (255 // max(levels - 1, 1))).astype(np.uint8)
    bias = rig = None
    if rng.random() < 0.5:
        bias = (rng.standard_normal((h, w)) * rng.choice([0.1, 1, 10])
                ).astype(np.float32)
    if rng.random() < 0.4:
        rig = np.abs(rng.standard_normal((h, w))
                     * rng.choice([1, 50])).astype(np.float32)
    return dict(img=img, bias=bias, rig=rig, delta_x=delta_x, nrg=nrg,
                ssf=ssf, n_seams=n_seams)


def _vs_jax(case):
    img = case["img"]
    h, w = img.shape[:2]
    cfg = EngineConfig(H=h, Wb=128, C=img.shape[2],
                       delta_x=case["delta_x"], nrg=case["nrg"],
                       side_switch_freq=case["ssf"],
                       has_bias=case["bias"] is not None,
                       has_rig=case["rig"] is not None)
    st = init_state(cfg, img, bias=case["bias"], rig=case["rig"])
    st = extend_map(cfg, st, jnp.int32(case["n_seams"]))
    return np.asarray(st.vs)[:, :w]


def _vs_sharded(case):
    """The column-sharded resize loop's visibility map (batch of 1 on
    the virtual 8-device mesh), or None when the mesh is unavailable."""
    import jax
    if len(jax.devices()) < 8:
        return None
    from lqr_tpu.parallel.sharding import make_mesh, extend_map_sharded

    img = case["img"]
    h, w = img.shape[:2]
    cfg = EngineConfig(H=h, Wb=128, C=img.shape[2],
                       delta_x=case["delta_x"], nrg=case["nrg"],
                       side_switch_freq=case["ssf"],
                       has_bias=case["bias"] is not None,
                       has_rig=case["rig"] is not None)
    st = init_state(cfg, img, bias=case["bias"], rig=case["rig"])
    stb = jax.tree.map(lambda x: jnp.asarray(x)[None], st)
    mesh = make_mesh(8, data=1)
    out = extend_map_sharded(mesh, cfg, stb,
                             jnp.full((1,), case["n_seams"], jnp.int32))
    return np.asarray(out.vs)[0, :, :w]


def test_fuzz_oracle_triangle():
    rng = np.random.default_rng(20260819)
    n_cases = 52
    for i in range(n_cases):
        case = _random_case(rng, i)
        tag = {k: v for k, v in case.items() if k != "img"}
        tag["shape"] = case["img"].shape
        tag["i"] = i

        vs_cpp = native.carve(case["img"], case["n_seams"],
                              bias=case["bias"], rig=case["rig"],
                              delta_x=case["delta_x"], nrg=case["nrg"],
                              ssf=case["ssf"])
        vs_jax = _vs_jax(case)
        assert np.array_equal(vs_jax, vs_cpp), f"JAX vs C++: {tag}"

        if case["nrg"] not in _NORM_NRGS:
            vs_np = oracle.compute_vs_map(
                case["img"], case["n_seams"], nrg=case["nrg"],
                bias=case["bias"], rig=case["rig"],
                delta_x=case["delta_x"], side_switch_freq=case["ssf"])
            assert np.array_equal(vs_np, vs_cpp), f"NumPy vs C++: {tag}"

        if i % 17 == 5:
            # the column-sharded resize loop on the
            # virtual 8-device mesh — the shard-local energy/DP/
            # backtrack/compact/commit must stay bit-equal across random
            # masks, delta_x, side-switch and seam counts
            vs_sh = _vs_sharded(case)
            if vs_sh is not None:
                assert np.array_equal(vs_sh, vs_cpp), f"sharded: {tag}"


def test_fuzz_materialize_roundtrip():
    """Carve-then-reinsert identity across random configs (SPEC.md §6):
    materializing back to ref_w from any depth reproduces the original."""
    rng = np.random.default_rng(77)
    for _ in range(12):
        h = int(rng.choice(_HS))
        w = int(rng.integers(16, 61))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        n = int(rng.integers(1, 8))
        vs = oracle.compute_vs_map(img, n)
        assert np.array_equal(oracle.materialize(img, vs, w), img)
        out_cpp = native.materialize(img, vs, w - n)
        out_np = oracle.materialize(img, vs, w - n)
        assert np.array_equal(out_cpp, out_np)


def test_fuzz_multipass_enlargement():
    """>200% enlargement sweep (VERDICT r3 weak #5): random configs with
    target > 2x width, exercising the flatten-and-restart law
    (carver.py:333-349; the reference's "Scaling beyond 200%" capability,
    /root/reference/NEWS:29, help/en/index.wiki:91) — the Carver's output
    must equal an independent replay through the C++ reference carver."""
    from lqr_tpu import Carver

    rng = np.random.default_rng(55)
    for i in range(8):
        h = int(rng.choice(_HS))
        w = int(rng.integers(16, 41))
        enl_step = float(rng.choice([1.2, 1.5, 1.9]))
        target = int(w * float(rng.uniform(2.05, 2.8)))
        img = (rng.integers(0, 16, (h, w, 3)) * 17).astype(np.uint8)

        c = Carver(img)
        c.set_enl_step(enl_step)
        c.resize(target, h)
        got = np.asarray(c.get_image())

        cur = img
        passes = 0
        while cur.shape[1] < target:
            ref = cur.shape[1]
            cap = max(ref + 1, int(ref * enl_step))
            pt = min(target, cap)
            k = min(pt - ref, ref - 1)
            pt = ref + k
            vs = native.carve(cur, k)
            cur = native.materialize(cur, vs, pt)
            passes += 1
        tag = f"case {i}: {w}->{target} step {enl_step} ({passes} passes)"
        assert passes >= 2, tag
        assert np.array_equal(got, cur), tag
