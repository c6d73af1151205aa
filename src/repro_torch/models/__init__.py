from repro_torch.models.model import (ModelConfig, active_param_count,
                                      forward, init_params, param_count,
                                      params_from_numpy, params_to_numpy)

__all__ = ["ModelConfig", "active_param_count", "forward", "init_params",
           "param_count", "params_from_numpy", "params_to_numpy"]
