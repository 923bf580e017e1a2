"""Sequential oracle types (reference semantics)."""

from .map import Map
from .mvreg import MVReg
from .orswot import Orswot

__all__ = ["Map", "MVReg", "Orswot"]
