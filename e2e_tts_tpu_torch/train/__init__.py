from .acoustic_step import (
    AcousticBatch,
    AcousticTrainState,
    build_acoustic_model,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from .checkpoint import CheckpointManager, scan_checkpoint, warm_start_params
from .e2e_step import E2EBatch, E2EState, init_e2e_state, make_e2e_train_step
from .optim import (
    AdamState,
    NoamAdam,
    ScheduledAdam,
    acoustic_optimizer,
    e2e_optimizers,
    exponential_decay,
    gan_optimizer,
    noam_schedule,
)
from .vocoder_step import (
    MEL_LOSS_WEIGHT,
    VocoderBatch,
    VocoderTrainState,
    init_vocoder_train_state,
    make_vocoder_train_step,
)
