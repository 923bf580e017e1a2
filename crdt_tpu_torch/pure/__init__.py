"""Sequential oracle types (reference semantics)."""

from .gcounter import GCounter
from .glist import GList
from .gset import GSet
from .identifier import Identifier
from .list import List
from .lwwreg import LWWReg
from .map import Map
from .merkle_reg import MerkleReg
from .mvreg import MVReg
from .orswot import Orswot
from .pncounter import Dir, PNCounter

__all__ = ["Dir", "GCounter", "GList", "GSet", "Identifier", "List", "LWWReg", "Map",
           "MerkleReg", "MVReg", "Orswot", "PNCounter"]
