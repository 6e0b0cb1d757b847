"""Plain PyTorch reference of the benchmark's configurations.

A frozen copy of the port's plain model code (Swin-T, ResNet-50 with
FrozenBN, the deformable pixel decoder, the Mask2Former and MaskDINO
decoders, the instance postprocess, the Mask2Former criterion with its
matcher, and the clipped AdamW update), with the deformable sampling done
by ``F.grid_sample`` sums and everything computed in float32 with TF32 off.
It imports nothing of the port, of JAX or of the JAX package, and takes
nothing the program made: the benchmark hands both sides the same seeded
weights and inputs.
"""
