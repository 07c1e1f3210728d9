"""Traffic kind ``train``: the port's training step in a closed loop.

Set-up builds one training state (``train.trainer``: the model in the
configuration's compute dtype, ``make_optimizer``'s Adam,
``build_train_step``), loads the benchmark's seeded weights into it and
drives it through the checked steps on pool batches 0, 1, 2: uploaded as
the ``Trainer``'s loop uploads a loader batch (``to_device``), stepped
through ``train_step``. The same state then runs the window: batches
3, 0, 1, ... back to back, the step's scalars accumulated on the device
and read every ``log_iter`` steps, as ``Trainer.train_epoch`` reads them;
the window ends in a synchronisation.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import model as M
from ..reference import train as RT
from . import compare, trace
from . import traffic as traffic_gen
from . import weights as W

CAFFE_MEAN = (103.939, 116.779, 123.68)


def program_config(cfg: dict, traffic: dict, device):
    from db_text_minimal_tpu_torch.config import default_config

    pc = default_config()
    pc.meta.device = str(device)
    pc.model.backbone = cfg["backbone"]
    pc.model.neck = cfg["neck"]
    pc.model.head = cfg["head"]
    pc.hps.batch_size = traffic["batch"]
    pc.hps.img_size = traffic["image_size"]
    pc.hps.log_iter = traffic["log_iter"]
    pc.optimizer.lr = cfg["optimizer"]["lr"]
    pc.optimizer.weight_decay = 0.0
    for key in ("reduction", "alpha", "beta", "negative_ratio"):
        setattr(pc.optimizer, key, cfg["loss"][key])
    pc.parallel.compute_dtype = cfg["train_dtype"]
    return pc


class ProgramTrainer:
    """The port's training state and step, built as the ``Trainer``
    builds them, on the benchmark's weights."""

    def __init__(self, cfg: dict, traffic: dict, weights: dict, device):
        import db_text_minimal_tpu_torch.train.trainer as T
        from db_text_minimal_tpu_torch.models import DBTextModel

        self.T = T
        self.device = torch.device(device)
        pc = program_config(cfg, traffic, device)
        # as the Trainer's constructor sets them for its process
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with self.device:
            model = DBTextModel(backbone_name=cfg["backbone"],
                                neck_name=cfg["neck"],
                                head_name=cfg["head"],
                                compute_dtype=T.compute_dtype(pc,
                                                              self.device))
        model.load_state_dict(weights, strict=True)
        self.state = T.TrainState(model, T.make_optimizer(pc, model))
        self.train_step = T.build_train_step(pc)
        self.lr = float(pc.optimizer.lr)
        self.beta1 = 0.9

    def upload(self, batch: dict) -> dict:
        return self.T.to_device(batch, self.device)

    def step(self, batch: dict):
        self.state, out, hist, _ = self.train_step(self.state, batch,
                                                   self.lr)
        return out, hist

    def first_grad_norms(self) -> dict:
        """Each parameter's gradient as Adam took it at step 1, from its
        first moment after that step: m = (1 − β1) · g; 0 where Adam holds
        no state for it."""
        state = self.state.optimizer.state
        return {name: (float(state[p]["exp_avg"].norm() / (1 - self.beta1))
                       if "exp_avg" in state.get(p, {}) else 0.0)
                for name, p in self.state.model.named_parameters()}

    def params(self) -> dict:
        return dict(self.state.model.named_parameters())


def pin(pool: list) -> list:
    """The pool's arrays as tensors in pinned host memory."""
    return [{k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
             for k, v in b.items()} for b in pool]


def checked_steps(prog: ProgramTrainer, batches: list, start: dict) -> dict:
    """The first steps through the window's own call, on distinct batches,
    with the readings the check compares (``reference.train.run_steps``'
    form)."""
    losses, grads = [], None
    for i, b in enumerate(batches):
        out, _ = prog.step(prog.upload(b))
        losses.append(float(out.total_loss))
        if i == 0:
            grads = prog.first_grad_norms()
    with torch.no_grad():
        upd = {k: float((p - start[k]).norm())
               for k, p in prog.params().items()}
    return {"losses": losses, "grad_norms": grads, "update_norms": upd}


def steps(prog: ProgramTrainer, pool: list, first: int, log_iter: int,
          until=None, count: int | None = None) -> tuple[int, int]:
    """Steps over ``pool`` from batch ``first`` on, while ``until()`` is
    true or for ``count`` steps; the losses and the 2×2 histogram summed
    on the device, read every ``log_iter`` steps and at the end. Ends in a
    synchronisation. Returns (steps, steps whose loss was not finite)."""
    loss_sum = torch.zeros((), device=prog.device)
    hist_sum = torch.zeros((2, 2), device=prog.device)
    pending: list = []
    n = failed = 0

    def flush():
        nonlocal failed
        with trace.span("read_scalars"):
            for out in pending:
                vals = [float(v) for v in out]
                failed += not all(np.isfinite(vals))
            hist_sum.double().cpu()
        pending.clear()

    while (count is not None and n < count) or (count is None and until()):
        with trace.span("upload"):
            batch = prog.upload(pool[(first + n) % len(pool)])
        with trace.span("train_step"):
            out, hist = prog.step(batch)
        loss_sum += out.total_loss
        hist_sum += hist
        pending.append(out)
        n += 1
        if n % log_iter == 0:
            flush()
    flush()
    float(loss_sum)
    if prog.device.type == "cuda":
        torch.cuda.synchronize()
    return n, failed


def reference_batches(pool: list, device) -> list:
    """The reference's own float32 NCHW images and unpacked maps of pool
    batches in the loader layout."""
    out = []
    for b in pool:
        width = b["img"].shape[2]
        maps = {k: torch.from_numpy(
            np.unpackbits(np.asarray(b[k]), axis=-1)[..., :width]
            .astype(np.float32)).to(device)
            for k in ("prob_map", "supervision_mask", "text_area_map")}
        maps["thresh_map"] = torch.from_numpy(
            np.asarray(b["thresh_map"], np.float32)).to(device)
        maps["x"] = RT.images_to_input(
            torch.from_numpy(np.asarray(b["img"])).to(device), CAFFE_MEAN)
        out.append(maps)
    return out


def reference_steps(cfg: dict, weights: dict, host_batches: list, device,
                    ops=None, rows: int | None = None) -> dict:
    """The reference's readings over ``host_batches``; ``rows`` keeps only
    that many rows of each batch (a fault planted for the check's test)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = reference_batches(host_batches, device)
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
    return RT.run_steps(weights, M.param_spec(cfg), cfg, batches,
                        ops or M.Ops("train"))


def free() -> None:
    """Returns what the program's freed state held to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    """One run of a train cell: set-up, the window, the traced part, the
    check. ``ctx`` (``harness.RunContext``) carries the cell and the
    run's options; returns the harness's result parts."""
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    ctx.mark("start")
    host_pool = traffic_gen.make_pool(traffic, ctx.seed, ctx.workers)
    pool = pin(host_pool) if device.type == "cuda" else [
        {k: torch.from_numpy(v) for k, v in b.items()} for b in host_pool]
    ctx.mark("traffic")
    weights = W.make(cfg, ctx.seed, device)
    prog = ctx.program_factory(cfg, traffic, weights, device)
    ctx.mark("program")
    n_check = compare.CHECK_STEPS
    got = checked_steps(prog, pool[:n_check], weights)
    ctx.mark("checked_steps")
    log_iter = traffic["log_iter"]
    warm = traffic["warmup_steps"]
    steps(prog, pool, n_check, log_iter, count=warm)
    first = n_check + warm
    ctx.mark("warmup")

    t0 = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    n, failed = steps(prog, pool, first, log_iter,
                      until=lambda: time.perf_counter() - t0 < ctx.seconds)
    window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    batch = traffic["batch"]
    out = {"attempted": n, "failed": failed, "memory_peak_bytes": memory,
           "end_to_end": {"train_img_per_s": n * batch / window_s,
                          "setup_s": setup_s},
           "window": {"units": n, "seconds": window_s}}
    if ctx.trace:
        units = traffic["profile_steps"]
        info = ctx.trace_info(units=n, window_s=window_s)
        view = trace.profile(
            lambda: steps(prog, pool, first + n, log_iter, count=units),
            units, info)
        out["view"] = view
    del prog
    free()
    ref = reference_steps(cfg, weights, host_pool[:n_check], device)
    out["numbers"], out["details"] = compare.train_readings(got, ref)
    return out
