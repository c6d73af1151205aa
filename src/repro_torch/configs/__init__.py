from repro_torch.configs.registry import (ARCHS, SHAPES, get_arch, get_shape,
                                          smoke_config)

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shape", "smoke_config"]
