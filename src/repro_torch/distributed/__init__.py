"""Store layouts for the fleet and the device mesh, gradient compression,
and the (data, model) mesh's sharding rules and one-process collectives
(``repro.distributed``'s counterpart)."""
from repro_torch.distributed.compression import (compression_ratio,
                                                 dequantize_int8,
                                                 ef_allreduce_leaf,
                                                 ef_allreduce_tree,
                                                 init_error_tree, quantize_int8)
from repro_torch.distributed.sharding import (Layout, all_gather, batch_axes,
                                              cache_pspecs, cache_shardings, gather,
                                              pmax, psum, psum_scatter, shard)
from repro_torch.distributed.store import (concat_stores, pad_store,
                                           shard_store, slot_range,
                                           stack_stores, store_from_arrays,
                                           store_to_arrays, to_device)

__all__ = ["pad_store", "shard_store", "slot_range", "stack_stores",
           "concat_stores", "to_device", "store_to_arrays",
           "store_from_arrays", "quantize_int8", "dequantize_int8",
           "ef_allreduce_leaf", "ef_allreduce_tree", "init_error_tree",
           "compression_ratio", "Layout", "batch_axes", "cache_pspecs",
           "cache_shardings", "shard", "gather", "psum", "pmax", "all_gather",
           "psum_scatter"]
