"""The port's training stack: AdamW, int8 gradient compression with error
feedback, checkpoints in the reference's format (saved and restored over
a mesh too), the straggler watchdog, the train step (one device, or a
rank's blocks over the data axis) and the single-device training loop
(`run_training`), and the reference's ZeRO-1 rule
(`zero1_logical_axes`)."""
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import (compress,
                                              compress_with_feedback,
                                              decompress, init_error)
from repro_torch.training.optim import (AdamWConfig, AdamWState, adamw_update,
                                        global_norm, init_adamw, lr_schedule,
                                        zero1_logical_axes)
from repro_torch.training.train_loop import (TrainConfig, TrainResult,
                                             make_train_step, run_training)
from repro_torch.training.watchdog import StepWatchdog, StragglerEvent

__all__ = [
    "AdamWConfig", "AdamWState", "CheckpointManager", "StepWatchdog",
    "StragglerEvent", "TrainConfig", "TrainResult", "adamw_update",
    "compress", "compress_with_feedback", "decompress", "global_norm",
    "init_adamw", "init_error", "lr_schedule", "make_train_step",
    "run_training", "zero1_logical_axes",
]
