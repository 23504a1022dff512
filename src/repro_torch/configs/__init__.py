from .registry import (ARCH_IDS, applicable_shapes, get_config,
                       get_shape, get_smoke_config)

__all__ = ["ARCH_IDS", "applicable_shapes", "get_config", "get_shape",
           "get_smoke_config"]
