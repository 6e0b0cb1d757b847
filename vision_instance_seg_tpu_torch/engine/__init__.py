"""Training engine: the train step, its optimizer and schedule, the
``Trainer`` loop, checkpoints and the COCO evaluator."""

from vision_instance_seg_tpu_torch.engine.trainer import (  # noqa: F401
    Trainer, TrainState, create_train_state, make_train_step)
