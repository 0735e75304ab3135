"""Round-3 regression tests: CLI --last size overrides, ID-based aux-layer
references, and interactive revalidation of externally mutated state."""

import numpy as np
import pytest

from lqr_tpu.config import LqrConfig, SeamColors, layer_ref_set
from lqr_tpu.errors import LqrImageError
from lqr_tpu.image_model import Image, Layer
from lqr_tpu.interactive import InteractiveSession
from lqr_tpu.render import init_carver, render_noninteractive


# -- CLI --last with explicit size override (main.c:388-390 +
#    size-entry parse; regression for the round-2 crash) -------------------

def _save(path, arr):
    from lqr_tpu.utils.image_io import save_image
    save_image(str(path), arr)


def _load(path):
    from lqr_tpu.utils.image_io import load_image
    return load_image(str(path))


def test_cli_last_with_int_size_override(tmp_path, make_image):
    from lqr_tpu.cli import main as cli_main
    inp = tmp_path / "in.png"
    st = tmp_path / "s.json"
    _save(inp, make_image(h=20, w=32))
    rc = cli_main([str(inp), "28", "20", "--save-vals", "--settings",
                   str(st), "-o", str(tmp_path / "o1.png")])
    assert rc == 0
    # the round-2 crash: explicit size + --last left raw strings in cfg
    rc = cli_main([str(inp), "55", "35", "--last", "--settings", str(st),
                   "-o", str(tmp_path / "o2.png")])
    assert rc == 0
    assert _load(tmp_path / "o2.png").shape == (35, 55, 3)


def test_cli_last_with_percent_size_override(tmp_path, make_image):
    from lqr_tpu.cli import main as cli_main
    inp = tmp_path / "in.png"
    st = tmp_path / "s.json"
    _save(inp, make_image(h=20, w=32))
    rc = cli_main([str(inp), "28", "20", "--save-vals", "--settings",
                   str(st), "-o", str(tmp_path / "o1.png")])
    assert rc == 0
    rc = cli_main([str(inp), "50%", "100%", "--last", "--settings", str(st),
                   "-o", str(tmp_path / "o2.png")])
    assert rc == 0
    assert _load(tmp_path / "o2.png").shape == (20, 16, 3)


# -- ID-based aux-layer references (main.c:556-576,
#    batch-gimp-lqr.scm:134-197 -full-use-id) ------------------------------

def test_layer_ref_by_id_and_name(make_image):
    img = Image.from_array(make_image(h=12, w=16))
    m = Layer("mask", np.zeros((12, 16, 3), np.uint8))
    img.add_layer(m, 0)
    assert img.layer_ref(m.layer_id) is m
    assert img.layer_ref("mask") is m
    assert img.layer_ref(-1) is None
    assert img.layer_ref("") is None
    assert img.layer_ref(10 ** 9) is None
    # copies get fresh IDs (GIMP semantics)
    assert m.copy().layer_id != m.layer_id


def test_layer_ref_set_predicate():
    assert layer_ref_set("mask")
    assert layer_ref_set(0)
    assert layer_ref_set(3)
    assert not layer_ref_set("")
    assert not layer_ref_set(-1)
    assert not layer_ref_set(None)


def test_render_with_id_based_disc_mask(make_image):
    """Config carrying an int layer ID must behave exactly like the same
    config carrying the layer's name."""
    base = make_image(h=20, w=32)
    mask = np.zeros((20, 32, 3), np.uint8)
    mask[:, 12:18] = 255

    def run(ref_of):
        img = Image.from_array(base.copy())
        m = Layer("discmask", mask.copy(), visible=False)
        img.add_layer(m, 0)
        cfg = LqrConfig(new_width=24, new_height=20,
                        disc_layer=ref_of(m))
        cd = init_carver(img, cfg)
        assert render_noninteractive(cfg, SeamColors(), cd)
        return cd.image.layer_by_name(cd.layer_name).pixels

    by_name = run(lambda m: m.name)
    by_id = run(lambda m: m.layer_id)
    assert np.array_equal(by_name, by_id)


# -- interactive revalidation (render.c:48-62, 485-500) --------------------

def test_interactive_detects_removed_layer(make_image):
    sess = InteractiveSession(Image.from_array(make_image(h=16, w=24)))
    sess.set_size(20, 16)                       # works
    sess.image.remove_layer(sess.cd.layer_name)  # external mutation
    with pytest.raises(LqrImageError):
        sess.set_size(18, 16)


def test_interactive_detects_bpp_change(make_image):
    sess = InteractiveSession(Image.from_array(make_image(h=16, w=24)))
    layer = sess.image.layer_by_name(sess.cd.layer_name)
    layer.add_alpha()                            # bpp 3 -> 4 under the carver
    with pytest.raises(LqrImageError):
        sess.set_size(20, 16)
