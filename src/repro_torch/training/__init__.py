from repro_torch.training.optimizer import (OptState, adamw_update,  # noqa
                                            init_opt_state, lr_schedule)
from repro_torch.training.train_loop import (Trainer,  # noqa
                                             make_train_step)
