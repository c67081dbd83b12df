from repro_torch.train.trainer import (TrainState,  # noqa: F401
                                       init_train_state, make_train_step)
from repro_torch.train import checkpoint  # noqa: F401
