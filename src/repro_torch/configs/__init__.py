"""Architecture configurations of the LM stack: copies of the reference
package's plain dataclasses, so the port needs no JAX to read them."""
from .base import ArchConfig, MoECfg, SSMCfg, HybridCfg, EncDecCfg, ShapeCfg, SHAPES
from .registry import ARCHS, get_arch, smoke
