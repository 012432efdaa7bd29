"""Store layouts for the fleet and the device mesh
(``repro.distributed``'s counterpart)."""
from repro_torch.distributed.store import (concat_stores, pad_store,
                                           shard_store, slot_range,
                                           stack_stores, store_from_arrays,
                                           store_to_arrays, to_device)

__all__ = ["pad_store", "shard_store", "slot_range", "stack_stores",
           "concat_stores", "to_device", "store_to_arrays",
           "store_from_arrays"]
