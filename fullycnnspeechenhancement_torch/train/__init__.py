"""Training: schedule, optimizer, train/eval steps, checkpoints, engine."""

from fullycnnspeechenhancement_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    export_params_npz,
    import_reference_npz,
    params_from_numpy,
    train_state_from_numpy,
)
from fullycnnspeechenhancement_torch.train.optim import (  # noqa: F401
    noam_schedule,
    tf_adam_init,
    tf_adam_update,
)
from fullycnnspeechenhancement_torch.train.step import (  # noqa: F401
    Batch,
    TrainState,
    create_train_state,
    make_eval_step,
    make_multi_step,
    make_train_step,
)
