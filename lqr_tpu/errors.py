"""Typed error discipline — the CATCH / *_CHECK macro replacement.

The reference surfaces failures through an error-code protocol plus
user-facing validation macros:

- ``LQR_OK`` / ``LQR_NOMEM`` + ``CATCH`` / ``CATCH_MEM``
  (/root/reference/src/render.c:42-46),
- ``BPP_CHECK`` / ``IMAGE_TYPE_CHECK`` (/root/reference/src/render.c:48-62),
- ``IMAGE_CHECK`` / ``LAYER_CHECK`` (/root/reference/src/main.h:131-153),

each printing a ``g_message`` a user can act on. The native analog here is a
small exception hierarchy: every public API boundary (Carver, render, CLI)
raises a typed ``LqrError`` with an actionable message instead of tripping
an assert; the CLI catches ``LqrError`` and exits cleanly.
"""

from __future__ import annotations

from .i18n import _


class LqrError(Exception):
    """Base class for all user-facing framework errors (CATCH analog)."""


class LqrConfigError(LqrError):
    """Invalid parameter value (defaults table bounds,
    /root/reference/src/main.c:62-128 and UI ranges in interface.c)."""


class LqrImageError(LqrError):
    """Invalid image/mask/layer data: bad channel count, shape mismatch,
    unusable mask placement (BPP_CHECK / LAYER_CHECK analog)."""


class LqrStateError(LqrError):
    """API misuse or broken internal invariant ("You just found a bug!"
    assertions, /root/reference/src/layers_combo.c:228)."""


def check_channels(c: int, what: str = "image") -> None:
    """BPP_CHECK (/root/reference/src/render.c:48-55): 1..4 channels."""
    if not 1 <= c <= 4:
        raise LqrImageError(
            _("{what} has {c} channels; only 1-4 (GRAY, GRAYA, RGB, RGBA) "
              "are supported").format(what=what, c=c))


def check_target_size(w: int, h: int) -> None:
    """Resize targets must be positive (altsizeentry lower bound)."""
    if w < 1 or h < 1:
        raise LqrConfigError(
            _("target size {w}x{h} is invalid; both sides must be >= 1")
            .format(w=w, h=h))
