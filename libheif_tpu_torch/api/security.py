"""Security-limits API (ref: api/libheif/heif_security.h, 5 fns;
heif_security_limits v1..v4 heif_security.h:37-88); counterpart of
libheif_tpu/api/security.py.
"""

from __future__ import annotations

from ..core.limits import SecurityLimits

heif_security_limits = SecurityLimits

_global_limits = SecurityLimits()


def heif_get_global_security_limits() -> SecurityLimits:
    """(ref: security_limits.cc global_security_limits)."""
    return _global_limits


def heif_get_disabled_security_limits() -> SecurityLimits:
    return SecurityLimits.disabled()


def heif_context_get_security_limits(ctx) -> SecurityLimits:
    return ctx.limits


def heif_context_set_security_limits(ctx, limits: SecurityLimits) -> None:
    ctx.limits = limits


def heif_security_limits_copy(dst: SecurityLimits,
                              src: SecurityLimits) -> None:
    for k, v in vars(src).items():
        setattr(dst, k, v)
