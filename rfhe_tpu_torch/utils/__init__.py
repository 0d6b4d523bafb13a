"""Shared utilities: the per-op graph cache (`jitcache`)."""
from .jitcache import HoistedJit, eager, hoisted_jit

__all__ = ["HoistedJit", "eager", "hoisted_jit"]
