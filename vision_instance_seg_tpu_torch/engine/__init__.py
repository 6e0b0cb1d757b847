"""Training engine: the train step, its optimizer and schedule."""

from vision_instance_seg_tpu_torch.engine.trainer import (  # noqa: F401
    TrainState, create_train_state, make_train_step)
