from .train_branch import (
    BranchTrainConfig,
    BranchTrainState,
    make_branch_train_step,
    make_lora_train_step,
    init_branch_train_state,
    encode_batch_latent_moments,
)
from .optim import make_optimizer, make_lr_schedule, cosine_with_restarts_schedule

__all__ = [
    "BranchTrainConfig",
    "BranchTrainState",
    "make_branch_train_step",
    "make_lora_train_step",
    "init_branch_train_state",
    "encode_batch_latent_moments",
    "make_optimizer",
    "make_lr_schedule",
    "cosine_with_restarts_schedule",
]
