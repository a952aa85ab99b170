from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, adamw_update, init_opt_state,
)
from repro_torch.training.train_loop import (
    init_opt_state_sharded, make_train_step, train,
)

__all__ = [
    "AdamWConfig", "DataConfig", "OptState", "SyntheticLM", "adamw_update",
    "init_opt_state", "init_opt_state_sharded", "load_checkpoint", "make_train_step", "save_checkpoint",
    "train",
]
