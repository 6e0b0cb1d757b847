"""Batch serving through the port's serving entry, closed loop.

Set-up draws the weights from the seed on the card (over the reference's
parameter tree) and loads them into ``build_model``'s model, makes a ring
of seeded uint8 batches on the card and hands them to the host, as the
eval loop's loader holds them, and warms the cell's one shape. The window
dispatches batch n + 1 before it waits for batch n, as
``engine/evaluator.py`` does: ``infer`` then every result leaf but
``mask_probs`` copied without blocking into pinned buffers. A batch's
time runs from its ``infer`` call to its copies' completion; the rate is
the images of the batches completed in the window over the time from its
start to the last completion in it.

After the window the outputs of sampled ring entries, as last served, are
judged against the reference's fp32 serving of the same images."""

from __future__ import annotations

import statistics
import time
from collections import deque

import torch
from torch.profiler import record_function

from benchmark import compare, flops, harness
from benchmark import trace as tr
from benchmark.reference import model as ref_model

PROFILED_BATCHES = 6


class _Done:
    """What a CPU run waits on: nothing."""

    def synchronize(self):
        pass


def host_copies(out: dict):
    """``engine/evaluator.py``'s ``_start_host_copies``: every leaf but
    mask_probs into pinned host buffers behind the compute; an event that
    completes with them."""
    cuda = next(iter(out.values())).is_cuda
    host = {}
    for key, v in out.items():
        if key == "mask_probs":
            continue
        host[key] = torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda)
        host[key].copy_(v, non_blocking=cuda)
    if not cuda:
        return host, _Done()
    event = torch.cuda.Event()
    event.record()
    return host, event


def cell_cfg(cell: harness.Cell) -> tuple:
    """The keys the traffic sets on the configuration, and the
    configuration with them as the reference reads it."""
    h, w = cell.traffic["canvas"]
    keys = {"INPUT.TEST_PAD_H": h, "INPUT.TEST_PAD_W": w}
    return keys, harness.with_keys(cell.config, **keys)


def weights(cfg_d: dict, seed: int, device) -> dict:
    ref = ref_model.build(cfg_d, device)
    ref_model.init_weights(ref, seed)
    return ref_model.state_dict_for_program(ref)


def inputs(cell: harness.Cell, cfg_d: dict, dev) -> tuple:
    """The ring of seeded uint8 batches (host numpy, as a loader holds
    them) and the ring entries whose served outputs are judged."""
    t = cell.traffic
    b, (h, w) = int(t["batch"]), t["canvas"]
    nc = cfg_d["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed % (2 ** 63) + 1)
    ring = [harness.make_images(gen, b, h, w, dev, nc, 1, with_gt=False)
            ["image"].cpu().numpy() for _ in range(int(t["ring"]))]
    pick = torch.Generator().manual_seed(cell.seed % (2 ** 63) + 2)
    checked = sorted(torch.randperm(len(ring), generator=pick)[
        :int(t["check_batches"])].tolist())
    return ring, checked


def run(cell: harness.Cell) -> dict:
    from vision_instance_seg_tpu_torch.models import (build_model,
                                                      make_inference_fn)

    t = cell.traffic
    b = int(t["batch"])
    keys, cfg_d = cell_cfg(cell)
    cfg = harness.port_cfg(cell.config, **keys)
    dev = torch.device(cell.device)
    harness.mark(cell, "imports")
    sd = weights(cfg_d, cell.seed, dev)
    harness.mark(cell, "weights drawn")
    model = build_model(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    del sd
    infer = make_inference_fn(model, cfg)
    harness.mark(cell, "model built")
    ring, checked = inputs(cell, cfg_d, dev)
    harness.mark(cell, "inputs made")

    # warm-up: the cell's one shape, through the loop's own calls
    for i in range(int(t["warmup_batches"])):
        host, ev = host_copies(infer(ring[i % len(ring)]))
        ev.synchronize()
    harness.synchronize(dev)
    harness.mark(cell, "warmed up")

    timers = None
    if cell.trace:
        tr.Profile.warm_up(dev)
        dec = model.sem_seg_head
        timers = (tr.StageTimer({"backbone": [model.backbone],
                                 "pixel_decoder": [dec.pixel_decoder],
                                 "decoder": [dec.predictor]}),
                  tr.SamplingTimer(msda_layers(model), backward=False))
    setup_s = time.perf_counter() - cell.t0

    lat_ms, enq_ms, done_images, last_done = [], [], 0, None
    last = {}
    pending = deque()
    start = time.perf_counter()
    end = start + cell.seconds
    profile, prof_stop, prof_done = None, -1, None
    n = 0

    def finish(item):
        nonlocal done_images, last_done
        t0, host, ev, i, out = item
        ev.synchronize()
        t1 = time.perf_counter()
        lat_ms.append((t1 - t0) * 1e3)
        if t1 <= end:
            done_images, last_done = done_images + b, t1
        if i % len(ring) in checked:
            last[i % len(ring)] = out

    # a traced run finishes its profiled stretch past the window's end
    while (time.perf_counter() < end
           or (profile is not None and prof_done is None)):
        if (cell.trace and profile is None
                and time.perf_counter() >= start + 0.4 * cell.seconds):
            # the profiled stretch starts and ends with nothing in flight
            while pending:
                finish(pending.popleft())
            profile = tr.Profile(harness.ROOT / "build" / "bench_trace"
                                 / f"{cell.name}.json")
            profile.start()
            marker = record_function("bench.traced")
            marker.__enter__()
            prof_t0, prof_stop = time.perf_counter(), n + PROFILED_BATCHES
        t0 = time.perf_counter()
        out = infer(ring[n % len(ring)])
        host, ev = host_copies(out)
        enq_ms.append((time.perf_counter() - t0) * 1e3)
        pending.append((t0, host, ev, n, out))
        n += 1
        if len(pending) > int(t["ahead"]):
            finish(pending.popleft())
        if n == prof_stop:
            while pending:
                finish(pending.popleft())
            prof_done = (PROFILED_BATCHES * b,
                         time.perf_counter() - prof_t0)
            marker.__exit__(None, None, None)
            profile.stop()
    while pending:
        finish(pending.popleft())
    harness.synchronize(dev)
    peak = harness.peak_bytes(dev)
    if last_done is None:
        raise RuntimeError("no batch completed within the window: give the "
                           "run more seconds")

    result = {
        "end_to_end": {
            "setup_s": setup_s,
            "serve_images_per_s": done_images / (last_done - start),
            "serve_batch_p95_ms": statistics.quantiles(
                lat_ms, n=20, method="inclusive")[-1]
            if len(lat_ms) > 1 else lat_ms[0]},
        "attempted": n, "failed": 0, "memory_peak_bytes": peak,
    }
    if cell.trace:
        result["readings"] = traced_readings(
            cell, cfg_d, profile, timers, prof_done, enq_ms, n, b)

    # the judged outputs leave the card before the program's state goes
    served = {i: {k: v.cpu() for k, v in out.items()}
              for i, out in last.items()}
    del model, infer, last, pending
    harness.empty_cache(dev)
    result["check"] = judge(cell, cfg_d, served,
                            {i: ring[i] for i in served}, dev)
    return result


def msda_layers(model) -> list:
    from vision_instance_seg_tpu_torch.models.deform_attn import MSDeformAttn

    return [m for m in model.modules() if isinstance(m, MSDeformAttn)]


def traced_readings(cell, cfg_d, profile, timers, prof_done, enq_ms, n, b):
    stage, sampling = timers
    reading = tr.TraceReading(*profile.read("bench.traced"))
    images, prof_s = prof_done
    h, w = cell.traffic["canvas"]
    readings = {"kind": "serve", "enqueue_ms": enq_ms, "batches": n,
                "stage_ms": stage.total_ms(), "sampling": sampling.totals(),
                "trace": reading, "rate": images / prof_s,
                "flops_per_image": flops.model_flops(
                    cfg_d, h, w, training=False)["total"]}
    stage.remove()
    sampling.remove()
    return readings


def reference_outputs(cell, cfg_d, images, dev, control=None) -> dict:
    """The reference's fp32 serving (TF32 off) of each sampled entry, in
    blocks of images; ``control`` wraps it (the control's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ref_model.build(cfg_d, dev)
    ref_model.init_weights(ref, cell.seed)
    ref.eval()
    block = int(cell.traffic["reference_block"])
    out = {}
    for i, x in images.items():
        x = torch.from_numpy(x)
        with (control() if control else torch.no_grad()):
            parts = [ref_model.serve(ref, cfg_d, x[s:s + block].to(dev))
                     for s in range(0, x.shape[0], block)]
        out[i] = {k: torch.cat([p[k].cpu() for p in parts])
                  for k in parts[0]}
    return out


def numbers(got: dict, want: dict, dev) -> dict:
    per = [compare.serve_numbers(got[i], want[i], dev) for i in want]
    return {k: max(p[k] for p in per) for k in per[0]}


def judge(cell, cfg_d, served: dict, images: dict, dev) -> harness.Check:
    want = reference_outputs(cell, cfg_d, images, dev)
    return harness.Check(numbers(served, want, dev),
                         harness.cell_limits(cell))


def control(cell: harness.Cell) -> dict:
    """The control's numbers: the reference with fp8 operands in the
    program's place, against the fp32 reference, on the entries a run of
    this seed judges."""
    from benchmark.reference.precision import Fp8Operands

    _, cfg_d = cell_cfg(cell)
    dev = torch.device(cell.device)
    ring, checked = inputs(cell, cfg_d, dev)
    images = {i: ring[i] for i in checked}
    want = reference_outputs(cell, cfg_d, images, dev)
    got = reference_outputs(cell, cfg_d, images, dev, Fp8Operands)
    return numbers(got, want, dev)
