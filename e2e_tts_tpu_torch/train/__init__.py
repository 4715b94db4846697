from .acoustic_step import (
    AcousticBatch,
    AcousticTrainState,
    build_acoustic_model,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from .optim import AdamState, NoamAdam, acoustic_optimizer, noam_schedule
