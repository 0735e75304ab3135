"""lqr_tpu — an accelerator-native content-aware image resizing (seam carving)
framework with the full capability surface of gimp-lqr-plugin + liblqr.

Layers (mirroring SURVEY.md §1, re-architected accelerator-first):

- ``lqr_tpu.core``     — the carver engine (liblqr replacement): energy
  stencils, row-DP, visibility maps, materialization. Pure JAX.
- ``lqr_tpu.ops``      — the CUDA seam-sweep kernel (GPU hot path).
- ``lqr_tpu.carver``   — the ``Carver`` host API (lqr_carver_* surface).
- ``lqr_tpu.parallel`` — batching (vmap) and column sharding (shard_map).
- ``lqr_tpu.render``   — orchestration (render.c replacement): output
  targets, scaleback, aux layers, seam-map output.
- ``lqr_tpu.gap``      — keyframe interpolation (GAP iterator).
- ``lqr_tpu.cli``      — batch command line (batch-gimp-lqr replacement).
- ``lqr_tpu.oracle``   — NumPy reference implementation (the test oracle).
"""

from .config import (LqrConfig, SeamColors, EnergyFunc, ResizeOrder,
                     OutputTarget, ScalebackMode, MaskBehavior, AuxLayerType)
from .carver import Carver
from .checkpoint import save_carver, load_carver
from .errors import LqrError, LqrConfigError, LqrImageError, LqrStateError
from .masks import colour_from_type, new_mask_layer, edit_mask
from .preview import preview

__version__ = "0.3.0"

__all__ = [
    "LqrConfig", "SeamColors", "EnergyFunc", "ResizeOrder", "OutputTarget",
    "ScalebackMode", "MaskBehavior", "AuxLayerType", "Carver",
    "save_carver", "load_carver", "LqrError", "LqrConfigError",
    "LqrImageError", "LqrStateError", "colour_from_type", "new_mask_layer",
    "edit_mask", "preview", "__version__",
]
