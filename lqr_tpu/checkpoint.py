"""Checkpoint / resume — serialize the (image, vmap, params) state triple.

The reference's two persistence mechanisms (SURVEY.md §5) map here as:

1. parameter persistence (gimp_set_data under ``plug_in_lqr``,
   /root/reference/src/main.c:487-506) -> the params dict in the archive;
2. the visibility map as a computation checkpoint (``lqr_vmap_dump`` /
   flatten / the interactive resume range [ref-depth, ref+depth],
   /root/reference/src/render.c:725, interface_I.c:543-553) -> the saved
   ``vs``/depth, from which the live map is reconstructed WITHOUT
   recarving: the shrunk-most compacted planes are re-derived by
   materializing the map at width ref_w - depth (compaction commutes with
   the per-pixel reader, so the restored planes are bit-identical to the
   carved ones and further ``extend_map`` calls continue the exact same
   seam sequence).

Format: a single .npz (refs + vmap arrays + a JSON params blob).
"""

from __future__ import annotations

import io
import json

import numpy as np
import jax
import jax.numpy as jnp

from .carver import Carver, VMap
from .core import engine as eng
from .core.energy import reader_plane

_FORMAT = 1

_PARAM_FIELDS = ("delta_x", "rigidity", "nrg", "res_order",
                 "side_switch_freq", "enl_step", "dump_vmaps")


def save_carver(path: str, c: Carver):
    """Serialize a Carver (refs, params, live map, recorded vmaps)."""
    params = {f: getattr(c, f) for f in _PARAM_FIELDS}
    params.update(format=_FORMAT, C=c._C, ref_w=c._ref_w, ref_h=c._ref_h,
                  w=c._w, h=c._h, orientation=c._orientation,
                  n_aux=len(c._aux), n_vmaps=len(c._vmaps),
                  has_bias=c._ref_bias is not None,
                  has_rig=c._ref_rig is not None)
    arrays = {"ref_img": np.asarray(jax.device_get(c._ref_img))}
    if c._ref_bias is not None:
        arrays["ref_bias"] = np.asarray(jax.device_get(c._ref_bias))
    if c._ref_rig is not None:
        arrays["ref_rig"] = np.asarray(jax.device_get(c._ref_rig))
    for i, a in enumerate(c._aux):
        arrays[f"aux{i}"] = np.asarray(jax.device_get(a))

    depth = 0
    if c._state is not None:
        depth = int(jax.device_get(c._state.depth))
        if depth > 0:
            H, W = c._local_dims(c._orientation)
            arrays["vs"] = np.asarray(jax.device_get(c._state.vs))[:, :W]
    params["depth"] = depth

    for i, vm in enumerate(c._vmaps):
        arrays[f"vmap{i}"] = vm.data
        params[f"vmap{i}_meta"] = [vm.depth, vm.ref_w, vm.ref_h,
                                   vm.orientation]

    buf = io.BytesIO()
    np.savez_compressed(buf, params=np.frombuffer(
        json.dumps(params).encode(), np.uint8), **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_carver(path: str) -> Carver:
    """Reconstruct a Carver; a live map resumes at its saved depth."""
    z = np.load(path)
    params = json.loads(bytes(z["params"]).decode())
    assert params["format"] == _FORMAT, params["format"]

    # files written while the caller could pick the seam-search backend
    # carry one more parameter; only _PARAM_FIELDS are read, so it is
    # ignored
    c = Carver(z["ref_img"], delta_x=params["delta_x"],
               rigidity=params["rigidity"])
    c.nrg = type(c.nrg)(params["nrg"])
    c.res_order = type(c.res_order)(params["res_order"])
    c.side_switch_freq = params["side_switch_freq"]
    c.enl_step = params["enl_step"]
    c.dump_vmaps = params["dump_vmaps"]
    if params["has_bias"]:
        c._ref_bias = jnp.asarray(z["ref_bias"])
    if params["has_rig"]:
        c._ref_rig = jnp.asarray(z["ref_rig"])
    for i in range(params["n_aux"]):
        c._aux.append(jnp.asarray(z[f"aux{i}"]))
    for i in range(params["n_vmaps"]):
        d, rw, rh, o = params[f"vmap{i}_meta"]
        c._vmaps.append(VMap(data=z[f"vmap{i}"], depth=d, ref_w=rw,
                             ref_h=rh, orientation=o))

    depth = params["depth"]
    if depth > 0:
        _restore_live_map(c, params["orientation"], z["vs"], depth)
    c._w, c._h = params["w"], params["h"]
    return c


def _restore_live_map(c: Carver, orientation: int, vs_np: np.ndarray,
                      depth: int):
    """Rebuild the live MapState from (refs, vs, depth) without recarving."""
    c._build_map(orientation)
    st, cfg = c._state, c._cfg
    H, Wb = cfg.H, cfg.Wb
    vs = jnp.zeros((H, Wb), jnp.int32)
    vs = vs.at[:, :vs_np.shape[1]].set(jnp.asarray(vs_np, jnp.int32))
    w_shrunk = st.ref_w - depth
    img_s = eng.materialize_array(st.ref, vs, st.ref_w, w_shrunk, Wb)
    cur_bias = (eng.materialize_array(st.bias, vs, st.ref_w, w_shrunk, Wb)
                if cfg.has_bias else None)
    cur_rig = (eng.materialize_array(st.rig, vs, st.ref_w, w_shrunk, Wb)
               if cfg.has_rig else None)
    c._depth_h = int(depth)
    c._state = st._replace(vs=vs, depth=jnp.int32(depth),
                           cur_b=reader_plane(img_s, cfg.nrg),
                           cur_bias=cur_bias, cur_rig=cur_rig)
