from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             train_state_init)
