"""The port's deformable sampling core and MSDeformAttn against the JAX
package's.

- ``ms_deform_attn_core_torch`` (the plain version of the CUDA kernel K1)
  against ``ms_deform_attn_core_jnp`` on ragged levels, 4 levels, off-map
  samples and offsets far beyond the halo, and against the Pallas kernel
  ``ms_deform_attn_encoder_pallas`` in interpret mode at the tiny shapes of
  tests/test_msdeform_kernel.py. fp32 on both sides; the sums run in
  another order, so the tolerance is 1e-5.
- ``MSDeformAttn`` against the JAX module with the offset clamp on
  (``TPU.USE_PALLAS_DEFORM_ATTN``) and off, for grid queries, free queries
  and box (4-d) reference points: fp32, atol 1e-4 (projections plus the
  core, different summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_instance_seg_tpu.kernels.msdeform_attn import (
    fused_ms_deform_attn, ms_deform_attn_encoder_pallas)
from test_torch_port_kernels import CASES, SHAPES, off_map, sampling_inputs
from vision_instance_seg_tpu.models.deform_attn import (
    MSDeformAttn as JaxMSDeformAttn, ms_deform_attn_core_jnp)
from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
from vision_instance_seg_tpu_torch.models.deform_attn import MSDeformAttn

CORE_CASES = {k: CASES[k] for k in ("ragged", "4-level", "off-map",
                                     "beyond-halo")}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_plain_core_matches_jnp_core(case):
    shapes, (value, loc, aw) = CORE_CASES[case]()
    want = ms_deform_attn_core_jnp(jnp.asarray(value), shapes,
                                   jnp.asarray(loc), jnp.asarray(aw))
    got = K.ms_deform_attn_core_torch(torch.from_numpy(value), shapes,
                                      torch.from_numpy(loc),
                                      torch.from_numpy(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("push_off", [False, True],
                         ids=["in-halo", "off-map"])
def test_plain_core_matches_pallas_interpret(push_off):
    """The TPU kernel K1 replaces, run in Pallas interpret mode."""
    value, loc, aw = sampling_inputs(0, offset_px=0.0 if push_off else 2.0)
    if push_off:
        value, loc, aw = off_map(value, loc, aw)
    want = ms_deform_attn_encoder_pallas(jnp.asarray(value), SHAPES,
                                         jnp.asarray(loc), jnp.asarray(aw),
                                         interpret=True)
    got = K.ms_deform_attn_core_torch(torch.from_numpy(value), SHAPES,
                                      torch.from_numpy(loc),
                                      torch.from_numpy(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ MSDeformAttn
DIM, HEADS, POINTS = 32, 4, 4
ATTN_SHAPES = [(3, 3), (16, 16), (6, 10)]   # 16 px: room past the halo


def _attn_case(kind, seed=7):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in ATTN_SHAPES)
    nl = len(ATTN_SHAPES)
    value = rng.standard_normal((2, s, DIM)).astype(np.float32)
    if kind == "grid":
        q = s
        refs = []
        for (h, w) in ATTN_SHAPES:
            gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                                 (np.arange(w) + 0.5) / w, indexing="ij")
            refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
        ref = np.tile(np.concatenate(refs)[None, :, None], (2, 1, nl, 1))
    elif kind == "free":
        q = 5
        ref = rng.uniform(0, 1, (2, q, nl, 2))
    else:   # box references (cx, cy, w, h)
        q = 5
        ref = np.concatenate([rng.uniform(0.2, 0.8, (2, q, nl, 2)),
                              rng.uniform(0.1, 0.5, (2, q, nl, 2))], -1)
    query = rng.standard_normal((2, q, DIM)).astype(np.float32)
    return query, ref.astype(np.float32), value


def _attn_params(seed=8):
    rng = np.random.default_rng(seed)
    nl = len(ATTN_SHAPES)
    n = HEADS * nl * POINTS

    def dense(i, o, scale=0.1):
        return {"kernel": rng.normal(0, scale, (i, o)).astype(np.float32),
                "bias": rng.normal(0, scale, (o,)).astype(np.float32)}

    # unit-scale offset weights: offsets reach well past the 6 px halo
    return {"sampling_offsets": dense(DIM, 2 * n, 1.0),
            "attention_weights": dense(DIM, n, 0.5),
            "value_proj": dense(DIM, DIM), "output_proj": dense(DIM, DIM)}


def _port_attn(params, clamp):
    m = MSDeformAttn(DIM, HEADS, len(ATTN_SHAPES), POINTS,
                     offset_clamp=6.0 if clamp else None)
    m.load_state_dict({f"{k}.{'weight' if leaf == 'kernel' else leaf}":
                       torch.from_numpy(v.T if leaf == "kernel" else v)
                       for k, d in params.items() for leaf, v in d.items()})
    return m


@pytest.mark.parametrize("kind", ["grid", "free", "box"])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
def test_msdeform_attn_matches_jax(kind, clamp):
    """clamp=True is the JAX module under TPU.USE_PALLAS_DEFORM_ATTN (its
    core carries the halo clamp; on the CPU it runs the jnp core)."""
    query, ref, value = _attn_case(kind)
    params = _attn_params()
    jm = JaxMSDeformAttn(DIM, HEADS, len(ATTN_SHAPES), POINTS,
                         core_fn=fused_ms_deform_attn if clamp else None)
    want = jm.apply({"params": params}, jnp.asarray(query), jnp.asarray(ref),
                    jnp.asarray(value), ATTN_SHAPES)
    with torch.no_grad():
        got = _port_attn(params, clamp)(
            torch.from_numpy(query), torch.from_numpy(ref),
            torch.from_numpy(value), ATTN_SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_offset_clamp_binds_grid_queries_only():
    """The clamp changes grid-query outputs (these offsets pass the halo)
    and leaves free queries alone."""
    params = _attn_params()
    for kind, differs in (("grid", True), ("free", False)):
        query, ref, value = (torch.from_numpy(a) for a in _attn_case(kind))
        with torch.no_grad():
            a = _port_attn(params, True)(query, ref, value, ATTN_SHAPES)
            b = _port_attn(params, False)(query, ref, value, ATTN_SHAPES)
        assert bool((a - b).abs().max() > 1e-3) == differs, kind
