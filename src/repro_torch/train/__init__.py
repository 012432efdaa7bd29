"""The training plane of the port (``repro.train``'s counterpart): AdamW,
the train step with autograd and remat, the step over a device mesh (a
(data, model) mesh; a 1-D mesh has one model slot), checkpoints in the
reference's format, and recovery."""
from repro_torch.train.optimizer import AdamW, AdamWState, warmup_cosine, constant_lr
from repro_torch.train.train_step import (batch_pspec, make_batch_shardings,
                                          make_state_shardings, make_train_step,
                                          shard_train_step, state_layout,
                                          value_and_grad)
from repro_torch.train.checkpoint import (save_checkpoint, restore_checkpoint,
                                          latest_step, prune_checkpoints)
from repro_torch.train.fault_tolerance import (WatchdogPolicy, plan_remesh,
                                               run_with_recovery, StepFailure)

__all__ = ["AdamW", "AdamWState", "warmup_cosine", "constant_lr",
           "make_train_step", "shard_train_step", "value_and_grad",
           "batch_pspec", "make_batch_shardings", "make_state_shardings",
           "state_layout",
           "save_checkpoint", "restore_checkpoint", "latest_step",
           "prune_checkpoints", "WatchdogPolicy", "plan_remesh",
           "run_with_recovery", "StepFailure"]
