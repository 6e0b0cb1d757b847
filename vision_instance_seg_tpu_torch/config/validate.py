"""Config validation: every accepted key is either wired or rejected loudly.

The config surface mirrors detectron2/Mask2Former/MaskDINO (SURVEY.md §2.2 —
reference yamls must merge cleanly), but this build implements the
reference's *used* envelope: instance segmentation, AdamW/SGD, zero decoder
dropout, post-norm decoder layers, fp32 params. Keys outside that envelope
are not silently ignored — ``validate_cfg`` (called from
``models.meta_arch.build_model``) raises on values the build does not
honor, so a config that would behave differently from detectron2 fails
fast instead of training the wrong model.

Keys validated here rather than consumed elsewhere:
- MASK_FORMER.TEST.{SEMANTIC_ON,PANOPTIC_ON,SEM_SEG_POSTPROCESSING_BEFORE_
  INFERENCE}: the reference evaluates instance only
  (training/maskdino/evaluate.py:120-124, tasks=("bbox","segm")); panoptic/
  semantic inference is out of scope, so OBJECT_MASK_THRESHOLD /
  OVERLAP_THRESHOLD / SEM_SEG_HEAD.IGNORE_VALUE (panoptic/semantic-only
  knobs) can never silently matter while those paths are rejected.
- MASK_FORMER.{DROPOUT,PRE_NORM}: every reference config uses 0.0 /
  post-norm; the decoders implement exactly that.
- MASK_FORMER.ENFORCE_INPUT_PROJ: this build always projects decoder
  inputs (input_proj{i} Denses), which satisfies True; False with matching
  dims is a d2 identity — both accepted (weight import maps either).
- SWIN.{DROP_RATE,ATTN_DROP_RATE}: 0.0 in all published Swin detection
  configs; stochastic depth (DROP_PATH_RATE) is implemented separately.
- TPU.PARAM_DTYPE: parameters are fp32 by design (CLAUDE.md conventions);
  compute precision is TPU.COMPUTE_DTYPE.

The port also rejects what its model build does not run: MaskDINO's dense
cross-attention (``MASK_DINO.CROSS_ATTENTION dense``) and a ResNet norm
other than FrozenBN (the JAX ResNet builds FrozenBN whatever
``RESNETS.NORM`` says). MaskDINO's denoising queries take GT, which the
serving path never passes; the port's MaskDINO decoder refuses GT.
"""

from __future__ import annotations


def _reject(cond: bool, msg: str):
    if cond:
        raise NotImplementedError(msg)


def validate_cfg(cfg) -> None:
    m = cfg.MODEL.MASK_FORMER
    _reject(m.TEST.PANOPTIC_ON,
            "MASK_FORMER.TEST.PANOPTIC_ON: panoptic inference is not "
            "implemented (the reference evaluates instance bbox/segm only)")
    _reject(m.TEST.SEMANTIC_ON,
            "MASK_FORMER.TEST.SEMANTIC_ON: semantic inference is not "
            "implemented (the reference evaluates instance bbox/segm only)")
    _reject(not m.TEST.INSTANCE_ON,
            "MASK_FORMER.TEST.INSTANCE_ON=False: instance inference is the "
            "only implemented test path")
    _reject(m.TEST.SEM_SEG_POSTPROCESSING_BEFORE_INFERENCE,
            "SEM_SEG_POSTPROCESSING_BEFORE_INFERENCE is a semantic/panoptic "
            "knob; those paths are not implemented")
    _reject(float(m.DROPOUT) != 0.0,
            "MASK_FORMER.DROPOUT != 0: decoder dropout is not implemented "
            "(all reference configs use 0.0)")
    _reject(bool(m.PRE_NORM),
            "MASK_FORMER.PRE_NORM: only the post-norm decoder layer order "
            "(the reference configs' setting) is implemented")
    if m.MATCHER not in ("hungarian", "hungarian_dfs", "greedy"):
        raise ValueError(f"MASK_FORMER.MATCHER {m.MATCHER!r} (hungarian, "
                         "hungarian_dfs or greedy)")
    if m.POINT_MODE not in ("random", "grid"):
        raise ValueError(f"MASK_FORMER.POINT_MODE {m.POINT_MODE!r} (random "
                         "or grid)")
    if m.TRANSFORMER_DECODER_NAME not in (
            "MultiScaleMaskedTransformerDecoder", "MaskDINODecoder"):
        raise ValueError(
            f"unknown TRANSFORMER_DECODER_NAME {m.TRANSFORMER_DECODER_NAME!r}")
    div = int(m.SIZE_DIVISIBILITY)
    if div > 1:
        for key in ("IMAGE_SIZE",):
            size = int(getattr(cfg.INPUT, key))
            if size % div:
                raise ValueError(
                    f"INPUT.{key}={size} is not divisible by "
                    f"MASK_FORMER.SIZE_DIVISIBILITY={div}")

    s = cfg.MODEL.SWIN
    _reject(float(s.DROP_RATE) != 0.0 or float(s.ATTN_DROP_RATE) != 0.0,
            "SWIN.DROP_RATE/ATTN_DROP_RATE: plain dropout inside Swin is "
            "not implemented (0.0 in all Swin detection configs; "
            "DROP_PATH_RATE stochastic depth IS implemented)")

    if cfg.INPUT.FORMAT not in ("RGB", "BGR"):
        raise ValueError(f"INPUT.FORMAT {cfg.INPUT.FORMAT!r} (RGB or BGR)")
    if cfg.INPUT.MASK_FORMAT not in ("polygon", "bitmask"):
        raise ValueError(f"INPUT.MASK_FORMAT {cfg.INPUT.MASK_FORMAT!r}")

    if cfg.SOLVER.OPTIMIZER not in ("ADAMW", "SGD"):
        raise ValueError(f"SOLVER.OPTIMIZER {cfg.SOLVER.OPTIMIZER!r}")
    if cfg.SOLVER.WARMUP_METHOD not in ("linear", "constant"):
        raise ValueError(f"SOLVER.WARMUP_METHOD {cfg.SOLVER.WARMUP_METHOD!r}")
    _reject(cfg.SOLVER.CLIP_GRADIENTS.ENABLED
            and float(cfg.SOLVER.CLIP_GRADIENTS.NORM_TYPE) != 2.0,
            "CLIP_GRADIENTS.NORM_TYPE: only the L2 global norm is "
            "implemented")

    md = cfg.MODEL.MASK_DINO
    if md.CROSS_ATTENTION not in ("deformable", "dense"):
        raise ValueError(f"MASK_DINO.CROSS_ATTENTION {md.CROSS_ATTENTION!r} "
                         "(deformable or dense)")
    if md.INITIALIZE_BOX_TYPE not in ("no", "bitmask", "mask2box"):
        raise ValueError(f"MASK_DINO.INITIALIZE_BOX_TYPE "
                         f"{md.INITIALIZE_BOX_TYPE!r} (no, bitmask or "
                         "mask2box)")
    dino = cfg.MODEL.META_ARCHITECTURE == "MaskDINO" or md.ENABLED
    _reject(dino and md.CROSS_ATTENTION == "dense",
            "MASK_DINO.CROSS_ATTENTION dense: the dense cross-attention is "
            "not ported yet (deformable is)")

    if cfg.MODEL.BACKBONE.NAME == "resnet":
        r = cfg.MODEL.RESNETS
        if int(r.DEPTH) not in (50, 101, 152):
            raise ValueError(f"RESNETS.DEPTH {r.DEPTH} (50, 101 or 152)")
        _reject(r.NORM != "FrozenBN",
                f"RESNETS.NORM {r.NORM!r}: the ResNet is built with "
                "FrozenBN only")

    fa = int(cfg.MODEL.BACKBONE.FREEZE_AT)
    if fa and cfg.MODEL.BACKBONE.NAME != "resnet":
        raise ValueError("MODEL.BACKBONE.FREEZE_AT is a ResNet stage "
                         "freeze (d2 semantics); Swin has no stage-freeze "
                         "in the reference stack")

    _reject(cfg.TPU.PARAM_DTYPE != "float32",
            "TPU.PARAM_DTYPE: parameters are fp32 by design; set "
            "TPU.COMPUTE_DTYPE for activation/matmul precision")
    if cfg.MODEL.SEM_SEG_HEAD.get("FPN_FUSION", "last") not in (
            "last", "chain"):
        raise ValueError("SEM_SEG_HEAD.FPN_FUSION must be 'last' "
                         "(upstream parity) or 'chain' (r1-r3 fusion)")
