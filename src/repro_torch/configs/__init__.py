"""Architecture configs ported so far.  ``get_config(name)`` is the
registry entry point; the other families' arch files arrive with their
model modules (ROADMAP queue 1, item 13)."""
from repro_torch.configs.base import (ArchConfig, get_config, register,
                                      list_archs, SHAPES, ShapeSpec)

# import for registration side effects
from repro_torch.configs import starcoder2_3b  # noqa: F401

__all__ = ["ArchConfig", "get_config", "register", "list_archs", "SHAPES",
           "ShapeSpec"]
