"""Store layouts for the fleet on one card (``repro.distributed``'s
counterpart; its multi-device layout waits for the multi-GPU slice)."""
from repro_torch.distributed.store import (concat_stores, pad_store,
                                           stack_stores, store_from_arrays,
                                           store_to_arrays)

__all__ = ["pad_store", "stack_stores", "concat_stores", "store_to_arrays",
           "store_from_arrays"]
