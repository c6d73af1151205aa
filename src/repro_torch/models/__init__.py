from repro_torch.models.model import (ModelConfig, forward, init_params,
                                      param_count, params_from_numpy,
                                      params_to_numpy)

__all__ = ["ModelConfig", "forward", "init_params", "param_count",
           "params_from_numpy", "params_to_numpy"]
