"""LoRA training of the DiT (counterpart of trajectorycrafter_tpu/training)."""

from trajectorycrafter_tpu_torch.training.lora import (
    apply_lora,
    init_lora_params,
    lora_target_paths,
)
from trajectorycrafter_tpu_torch.training.step import TrainState, make_train_step
