"""The model zoo of the port: parameter specs, layers, MoE, SSD, the six
families' forward, and prefill / decode over KV and SSM caches."""
from repro_torch.models.model import Model, cross_entropy
from repro_torch.models.decoding import (cache_shapes, decode_step, init_cache,
                                         prefill)
from repro_torch.models.params import (ParamInfo, count_params, init_params,
                                       named_params, params_from_numpy)

__all__ = ["Model", "cross_entropy", "cache_shapes", "decode_step",
           "init_cache", "prefill", "ParamInfo", "count_params", "init_params",
           "named_params", "params_from_numpy"]
