"""Training through the port's train step, one step after another.

Set-up draws the weights from the seed on the card (over the reference's
parameter tree) into ``build_model``'s model, builds the train state and
``make_train_step``, and makes a ring of seeded batches in the loader's
layout on the card, handed to the host; ``prefetch_to_device`` feeds them
to the step as ``Trainer`` does. The first steps run through the
window's own call and feed on distinct batches: they warm every shape,
and their losses, the optimizer's first gradients and the parameters'
change over them are what the reference is held to. The same state then
trains through the window. A step ends when its logs reach the host; the
rate is the images of the steps completed in the window over the time
from its start to the last completion in it.

After the window the reference repeats those first steps in fp32 from
the same seeded weights, batches and step seeds."""

from __future__ import annotations

import itertools
import time

import torch
from torch.profiler import record_function

from benchmark import compare, flops, harness
from benchmark import trace as tr
from benchmark.drivers.serve import msda_layers, weights
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.backbones import drop_path_draws
from benchmark.reference.layers import PresetDraws

PROFILED_STEPS = 3
BETA1 = 0.9          # the program's AdamW first-moment decay


def cell_cfg(cell: harness.Cell) -> tuple:
    """The keys the traffic sets on the configuration, and the
    configuration with them as the reference reads it."""
    t = cell.traffic
    keys = {"SOLVER.IMS_PER_BATCH": int(t["batch"]),
            "INPUT.IMAGE_SIZE": int(t["canvas"]),
            "INPUT.MAX_INSTANCES": int(t["max_instances"])}
    return keys, harness.with_keys(cell.config, **keys)


def ring_batches(cell: harness.Cell, cfg_d: dict, dev) -> list:
    """The ring of seeded batches in the loader's layout (host numpy)."""
    t = cell.traffic
    b, s, m = int(t["batch"]), int(t["canvas"]), int(t["max_instances"])
    nc = cfg_d["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed % (2 ** 63) + 1)
    return [{k: v.cpu().numpy() for k, v in harness.make_images(
        gen, b, s, s, dev, nc, m, tuple(t["instances"])).items()}
        for _ in range(int(t["ring"]))]


def run(cell: harness.Cell) -> dict:
    from vision_instance_seg_tpu_torch.data.loader import prefetch_to_device
    from vision_instance_seg_tpu_torch.engine.trainer import (
        create_train_state, make_train_step)
    from vision_instance_seg_tpu_torch.models import build_model

    t = cell.traffic
    b, s = int(t["batch"]), int(t["canvas"])
    keys, cfg_d = cell_cfg(cell)
    cfg = harness.port_cfg(cell.config, **keys)
    dev = torch.device(cell.device)
    harness.mark(cell, "imports")
    sd = weights(cfg_d, cell.seed, dev)
    harness.mark(cell, "weights drawn")
    model = build_model(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    harness.mark(cell, "model built")
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)
    harness.mark(cell, "train state built")
    ring = ring_batches(cell, cfg_d, dev)
    harness.mark(cell, "inputs made")
    feed = prefetch_to_device(itertools.cycle(ring),
                              int(cfg.DATALOADER.PREFETCH_BATCHES), dev)

    # the first steps, through the window's call and feed
    names = {id(p): n for n, p in model.named_parameters()}
    first = int(t["check_steps"])
    losses, grad = [], {}
    for k in range(first):
        state, logs = step(state, next(feed), cell.seed)
        losses.append(logs["loss_total"])
        if k == 0:
            grad = {names[id(p)]: float(st["exp_avg"].norm()) / (1 - BETA1)
                    for p, st in state.optimizer.state.items()}
    change = {n: float((p.detach() - sd[n]).norm())
              for n, p in model.named_parameters()}
    prog = {"loss": losses, "grad": grad, "change": change}
    del sd
    harness.synchronize(dev)
    harness.mark(cell, "first steps run")

    sampling = None
    if cell.trace:
        tr.Profile.warm_up(dev)
        sampling = tr.SamplingTimer(msda_layers(model), backward=True)
    setup_s = time.perf_counter() - cell.t0
    steps, done_images, last_done = 0, 0, None
    start = time.perf_counter()
    end = start + cell.seconds
    profile, prof_done = None, None
    # a traced run finishes its profiled stretch past the window's end
    while (time.perf_counter() < end
           or (profile is not None and prof_done is None)):
        if (cell.trace and profile is None
                and time.perf_counter() >= start + 0.4 * cell.seconds):
            profile = tr.Profile(harness.ROOT / "build" / "bench_trace"
                                 / f"{cell.name}.json")
            profile.start()
            marker = record_function("bench.traced")
            marker.__enter__()
            prof_t0, prof_steps = time.perf_counter(), 0
        state, logs = step(state, next(feed), cell.seed)
        steps += 1
        t1 = time.perf_counter()
        if t1 <= end:
            done_images, last_done = done_images + b, t1
        if profile is not None and prof_done is None:
            prof_steps += 1
            if prof_steps == PROFILED_STEPS:
                harness.synchronize(dev)
                prof_done = (PROFILED_STEPS * b,
                             time.perf_counter() - prof_t0)
                marker.__exit__(None, None, None)
                profile.stop()
    harness.synchronize(dev)
    peak = harness.peak_bytes(dev)
    if last_done is None:
        raise RuntimeError("no step completed within the window: give the "
                           "run more seconds")
    feed.close()
    result = {"end_to_end": {"setup_s": setup_s,
                             "train_images_per_s": done_images
                             / (last_done - start)},
              "attempted": steps, "failed": 0, "memory_peak_bytes": peak}
    if cell.trace:
        reading = tr.TraceReading(*profile.read("bench.traced"))
        result["readings"] = {
            "kind": "train", "steps": PROFILED_STEPS, "trace": reading,
            "sampling": sampling.totals(), "rate": prof_done[0]
            / prof_done[1],
            "flops_per_image": flops.model_flops(cfg_d, s, s,
                                                 training=True)["total"]}
        sampling.remove()
    del model, state, step, feed
    harness.empty_cache(dev)
    result["check"] = judge(cell, cfg_d, prog, ring[:first], dev)
    return result


def reference_steps(cfg_d: dict, seed: int, batches: list, dev, block: int,
                    control=None) -> dict:
    """The reference's first steps from the seeded weights: losses, each
    leaf's first gradient after the clip (as the optimizer takes it) and
    each leaf's change over the steps. Each step's gradient is summed
    over blocks of ``block`` images, each with its rows of the batch's
    draws and the batch's normalizers, so it fits beside nothing else.
    ``control`` wraps each block (the control's lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ref_model.build(cfg_d, dev)
    ref_model.init_weights(model, seed)
    model.train()
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    groups = ref_train.param_groups(model, cfg_d)
    opt = ref_train.AdamW(groups, cfg_d)
    names = {id(p): n for n, p in model.named_parameters()}
    queries = cfg_d["MODEL"]["MASK_FORMER"]["NUM_OBJECT_QUERIES"]
    losses, grad = [], {}
    for k, batch in enumerate(batches):
        gen = torch.Generator(device=dev)
        gen.manual_seed(ref_train.step_seed(seed, k))
        x = {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}
        b, slots = x["gt_classes"].shape
        valid = torch.arange(slots, device=dev)[None] \
            < x["num_instances"][:, None]
        drops = drop_path_draws(model, b, gen)
        draws = ref_train.criterion_draws(cfg_d, b, slots, gen, dev)
        totals = ref_train.batch_totals(valid, queries, cfg_d)
        for p in model.parameters():
            p.grad = None
        loss = 0.0
        for s in range(0, b, block):
            rows = slice(s, s + block)
            with (control() if control else torch.enable_grad()):
                cls, masks = model(model.normalize(x["image"][rows]),
                                   aux_masks=True,
                                   generator=PresetDraws(drops, rows))
                part = ref_train.criterion(
                    cls, masks, x["gt_classes"][rows].long(),
                    x["gt_masks"][rows], valid[rows], cfg_d,
                    ref_train.draws_of_rows(draws, rows), totals)
                part.backward()
            loss += float(part.detach())
            del cls, masks, part
        opt.step(k)
        losses.append(loss)
        if k == 0:
            grad = {names[i]: float(v.norm()) / (1 - BETA1)
                    for i, v in opt.m.items()}
    change = {n: float((p.detach() - p0[n]).norm())
              for n, p in model.named_parameters()}
    return {"loss": losses, "grad": grad, "change": change}


def quiet_leaves(ref: dict) -> list:
    """Leaves whose first reference gradient is under a thousandth of the
    median leaf's: AdamW moves them by round-off alone."""
    norms = torch.tensor(list(ref["grad"].values()))
    med = norms.median().item()
    return [k for k, v in ref["grad"].items() if v < 1e-3 * med]


def judge(cell, cfg_d, prog: dict, batches: list, dev) -> harness.Check:
    ref = reference_steps(cfg_d, cell.seed, batches, dev,
                          int(cell.traffic["reference_block"]))
    skip = quiet_leaves(ref)
    cell.notes["worst_leaves"] = {
        "grad": compare.worst(compare.leaf_gaps(prog["grad"], ref["grad"])),
        "change": compare.worst(compare.leaf_gaps(
            prog["change"], ref["change"], skip)),
        "losses": [prog["loss"], ref["loss"]], "skipped": len(skip)}
    numbers = compare.train_numbers(prog, ref, skip)
    return harness.Check(numbers, harness.cell_limits(cell))


def control(cell: harness.Cell) -> dict:
    """The control's numbers: the reference's first steps with fp8
    operands in the program's place, against the fp32 reference's."""
    from benchmark.reference.precision import Fp8Operands

    t = cell.traffic
    _, cfg_d = cell_cfg(cell)
    dev = torch.device(cell.device)
    batches = ring_batches(cell, cfg_d, dev)[:int(t["check_steps"])]
    block = int(t["reference_block"])
    ref = reference_steps(cfg_d, cell.seed, batches, dev, block)
    got = reference_steps(cfg_d, cell.seed, batches, dev, block,
                          Fp8Operands)
    return compare.train_numbers(got, ref, quiet_leaves(ref))
