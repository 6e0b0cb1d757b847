"""The port's training, evaluation and visualization CLIs, the counterparts
of the JAX package's ``training/`` scripts (``python -m
vision_instance_seg_tpu_torch.training.maskdino.train_original ...``)."""
