"""Training driver: ``veloxseg_tpu/train/trainer.py`` on PyTorch, one device.

One generic loop parameterised by a dataset profile, as the JAX package
runs the reference's three per-dataset trainers
(``utils/train_autopet.py``, ``train_hecktor.py``, ``train_brats2021.py``):

- the sorted-filename 60/20/20 split; an effective batch of
  ``batch_size``·``num_samples`` patches (``num_samples`` 2);
- the warmup → main learning rate, set per epoch, and the plateau step;
- labels collapsed to binary for the PET/CT datasets
  (``train_autopet.py:236``);
- per-iteration loss and head-0 metrics in the log (and TensorBoard, where
  it is installed), each head's with ``show_deep_metric``;
- validation every ``val_interval`` epochs (``segmentation_metrics``, or
  ``brats_dice`` for BraTS); checkpoints ``<epoch>.pth`` every
  ``save_model_interval`` epochs, ``train_best.pth`` and ``val_best.pth``
  under ``save/<dataset>/<model>/<MM_DD>[_index]/``; resume from
  ``--checkpoint_path`` (a ``.pth`` of this trainer or the JAX trainer's
  ``.ckpt``);
- the step's metrics fetched to the host in one copy, one step late, so the
  fetch overlaps the next step; the threaded patch loader and pinned,
  non-blocking host→device copies (``prefetch``); ``grad_accum``;
  ``async_checkpoint`` writes on a background thread; ``profile_dir``
  traces dispatches 2-12 of the first epoch.

The steps compute in bf16 with fp32 master weights and optimizer state,
as the JAX trainer's (``trainer.py:297-348``: ``compute_dtype=bfloat16``
for the single step, ``grad_accum`` and ``steps_per_dispatch``); the
validation forward runs in fp32, as the JAX ``eval_step_fn`` does.

Deltas from the JAX trainer:

- no blocked heads (``trainer.py:240-250``, a TPU layout): the same metrics
  come from the unblocked head 0.
- one device: ``--mesh`` and ``--distributed`` raise (``ROADMAP.md`` §1
  item 5).
- the models of :data:`TRAINABLE`: VeloxSeg, and twelve of the zoo:
  U-RWKV, UNet, MedNeXt, SwinUNETR, U-KAN and SegFormer, which draw
  nothing in training (U-RWKV's WKV backward is kernel K6b), and
  VNet, UNETR, SlimUNETR, NestedFormer, SuperLightNet and HCMA-UNet, which
  draw their dropouts (SuperLightNet its fold directions) from the step's
  generator (``train_state.takes_generator``). The other four raise
  (:data:`UNTRAINED`: ``ROADMAP.md`` §1 item 6). The loss is the model's
  branch of ``CompositeLoss``; a sized model (SwinUNETR, UNETR,
  NestedFormer, HCMA-UNet) whose entry names no size is built for the
  patch, and NestedFormer at Hecktor's size raises ``CannotRunAtShape``
  before any step, as its builder does.
- ``steps_per_dispatch`` K is accepted (still exclusive of ``grad_accum``)
  and logged, and the loop steps one batch at a time: the JAX trainer
  scans K steps in one dispatch, and eager PyTorch issues K steps as K
  single steps, with the same numbers.
- each epoch also logs where its time went: the steps (the median step's
  stream span between CUDA events on the card: the host's issue of the
  step and the device's work, whichever ends later), the wait for the
  loader (and how much of it the first batch took), the checkpoint
  writes and the validation.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..data.dataset import (PatchLoader, SegmentationDataset,
                            default_train_transform, default_val_transform)
from ..data.nifti_fast import native_status
from ..data.prefetch import device_put, prefetch_to_device
from ..models.registry import load_model
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.profiling import ThroughputMeter, start_trace
from ..utils.runtime import (rotation_range_from_degrees,
                             validate_selected_modal)
from ..utils.seed import DEFAULT_SEED, seed_everything
from .checkpoint import load_checkpoint, save_checkpoint
from .loss import CompositeLoss
from .metrics import segmentation_metrics
from .metrics_brats import brats_dice
from .optim import EpochScheduler, build_optimizer, set_learning_rate
from .train_state import create_train_state, eval_step_fn, train_step_fn


# the models the port trains
TRAINABLE = ("VeloxSeg", "U-RWKV", "UNet", "MedNeXt", "SwinUNETR", "U-KAN",
             "VNet", "UNETR", "SegFormer", "SlimUNETR", "NestedFormer",
             "SuperLightNet", "HCMA-UNet")
# the zoo models it does not train yet → what their training forward needs
UNTRAINED = {
    "UNETRpp": "its deep-supervision train forward",
    "VSmTrans": "DropPath and its deep-supervision train forward",
    "HDense": "its deep-supervision train forward",
    "A2FSeg": "its 1 + 5·N grouped train outputs",
}


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    glob_keys: Tuple[str, ...]      # train-config dataset_path keys, order
    modality_names: Tuple[str, ...]
    use_foreground_crop: bool
    binary_label: bool
    raw_modal_count: int


PROFILES: Dict[str, DatasetProfile] = {
    "AutoPETII": DatasetProfile(("ct_path", "pet_path"), ("ct", "pet"),
                                True, True, 2),
    "Hecktor2022": DatasetProfile(("ct_path", "pet_path"), ("ct", "pet"),
                                  False, True, 2),
    "BraTS2021": DatasetProfile(
        ("flair_path", "t1_path", "t1ce_path", "t2_path"),
        ("flair", "t1", "t1ce", "t2"), False, False, 4),
}


class _AuxFetch:
    """One step's aux, fetched to the host in ONE copy.

    The scalars are stacked on the device right after the step and copied
    into pinned host memory without blocking; :meth:`result` waits for
    that copy alone. The trainer calls it after launching the next step,
    so the wait overlaps that step (the JAX trainer's one-step-lagged
    ``device_get``, ``trainer.py:79-101``)."""

    def __init__(self, aux: Dict):
        self.keys: List[Tuple] = []
        values = []
        for k, v in aux.items():
            if k == "deep":
                for i, head in enumerate(v):
                    for hk, hv in head.items():
                        self.keys.append(("deep", i, hk))
                        values.append(hv)
            else:
                self.keys.append((k,))
                values.append(v)
        packed = torch.stack([v.to(torch.float64) for v in values])
        self.event = None
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def result(self) -> Dict:
        """The step's aux as floats."""
        if self.event is not None:
            self.event.synchronize()
        d: Dict = {}
        for key, value in zip(self.keys, self.host.tolist()):
            if key[0] == "deep":
                heads = d.setdefault("deep", [])
                while len(heads) <= key[1]:
                    heads.append({})
                heads[key[1]][key[2]] = value
            else:
                d[key[0]] = value
        if "deep" in d:
            d["deep"] = tuple(d["deep"])
        return d


class _StepTimer:
    """Each step's time: CUDA events around it on the card, read only at
    the epoch's end so the loop never waits for them; the host clock on
    the CPU, where the step is synchronous. On the card this is the
    stream span from the step's start to its last operation: where the
    device keeps up with the host, as at the 96³ step, the span is the
    host's issue of the step, not device time."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> List[float]:
        pairs = list(zip(self.marks[0::2], self.marks[1::2]))
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def _grouped(it, k: int):
    """Group (x, y) device batches into stacked (A, ...) pairs for
    gradient accumulation. Same-shape groups only: a shape change (the
    final ragged batch) flushes the pending items as single steps
    (``veloxseg_tpu/train/trainer.py:104-127``)."""
    if k <= 1:
        yield from it
        return
    group = []
    for xy in it:
        if group and tuple(xy[0].shape) != tuple(group[0][0].shape):
            yield from group
            group = []
        group.append(xy)
        if len(group) == k:
            yield (torch.stack([g[0] for g in group]),
                   torch.stack([g[1] for g in group]))
            group = []
    yield from group


def run_train(args, train_config: dict, model_config: dict,
              device: Optional[Union[str, torch.device]] = None) -> dict:
    """Train ``args.model_name`` on ``args.dataset_name`` (signature of the
    reference's ``run_train``, plus ``device``: default ``"cuda"``, which
    raises without CUDA unless ``"cpu"`` is asked for).

    Returns ``{best_train_dice, best_val_dice, save_path, state}``, the
    last the :class:`~.train_state.TrainState` after the last epoch."""
    for flag in ("mesh", "distributed"):
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag}: the port trains on one device "
                "(multi-GPU: ROADMAP.md §1 item 5)")
    dev = resolve_device(device)
    profile = PROFILES[args.dataset_name]
    if args.model_name not in model_config:
        raise ValueError(
            f"Model {args.model_name!r} not present in the model config; "
            f"available: {sorted(model_config)}")
    if args.model_name not in TRAINABLE:
        need = UNTRAINED.get(args.model_name, "its training forward")
        raise NotImplementedError(
            f"the port trains {', '.join(TRAINABLE)}; {args.model_name} "
            f"needs {need} (ROADMAP.md §1 item 6)")
    date = datetime.now().strftime("%m_%d")

    # Resume re-derives the run dir from the checkpoint path
    # (``train_autopet.py:69-86``).
    if getattr(args, "checkpoint_path", None):
        date = os.path.basename(
            os.path.dirname(args.checkpoint_path)) or date
        index = ""
    else:
        index = (f"_{args.model_index}"
                 if getattr(args, "model_index", None) else "")

    save_path = os.path.join(train_config["save_path"], args.dataset_name,
                             args.model_name, date + index)
    os.makedirs(save_path, exist_ok=True)
    logger = get_logger(os.path.join(
        train_config.get("log_path", save_path),
        f"{args.dataset_name}_{args.model_name}_{date}{index}.log"))
    logger.info(f"Checkpoint Save path: {save_path}")
    logger.info(f"Now Model Config: \n{model_config[args.model_name]}\n")
    logger.info(f"device {dev}; steps in bfloat16, validation in float32; "
                + native_status())

    modal_index = validate_selected_modal(
        args.model_name, model_config,
        raw_modal_count=profile.raw_modal_count,
        select_modal=getattr(args, "select_modal", None))
    logger.info(f"Modal_index: {modal_index}")

    # Dataset --------------------------------------------------------
    patterns = {name: train_config["dataset_path"][args.dataset_name][k]
                for k, name in zip(profile.glob_keys,
                                   profile.modality_names)}
    patterns["label"] = \
        train_config["dataset_path"][args.dataset_name]["label_path"]
    dataset = SegmentationDataset.from_globs(patterns, args.dataset_name)
    train_files, val_files, _ = dataset.split(
        train_config["train_rate"], train_config["val_rate"])
    logger.info(f"The number of samples: {dataset.length}")
    logger.info(f"Training set includes: {len(train_files)}")
    logger.info(f"Validation set includes: {len(val_files)}")

    # Model / optimizer / loss --------------------------------------
    patch_size = train_config["patch_size"][args.dataset_name]
    generator = seed_everything(DEFAULT_SEED, dev)  # reference seed (C17)
    # a sized model (SwinUNETR's bias tables) is built for the patch, as
    # the JAX trainer's init on a patch-sized example sizes it
    model = load_model(args.model_name, model_config, device=dev,
                       seed=DEFAULT_SEED, input_size=patch_size)
    opt_cfg = train_config["optimizer"]
    optimizer = build_optimizer(opt_cfg["optimizer_type"],
                                opt_cfg["optimizer_args"],
                                model.parameters())
    state = create_train_state(model, optimizer)
    scheduler = EpochScheduler(train_config)
    in_ch = model_config[args.model_name].get("in_ch", [1, 1])
    num_modal = len(in_ch) if isinstance(in_ch, (list, tuple)) else 1
    loss_obj = CompositeLoss(args.model_name, train_config,
                             num_modal=num_modal)

    start_epoch = 0
    best_train_dice = 0.0
    best_val_dice = 0.0
    if getattr(args, "checkpoint_path", None):
        payload = load_checkpoint(args.checkpoint_path, model, optimizer)
        start_epoch = payload["epoch"] + 1
        best_train_dice = payload["best_train_dice"]
        best_val_dice = payload["best_val_dice"]
        scheduler.load_state_dict(payload["scheduler_state"])
        logger.info(f"Resumed from {args.checkpoint_path} at epoch "
                    f"{start_epoch}")

    # Per-deep-head metric reporting (reference ``show_deep_metric`` key,
    # ``utils/train_autopet.py:252`` → ``utils/metric/metrics.py:6-25``).
    show_deep = bool(train_config.get("show_deep_metric", True))
    step = train_step_fn(loss_obj, dev, deep_metric_heads=show_deep,
                         compute_dtype=torch.bfloat16)
    # ``grad_accum`` A > 1: one update from A loader batches' averaged
    # gradients, logged as one iteration. ``steps_per_dispatch`` K > 1 is
    # the JAX trainer's K steps in one dispatch; eager PyTorch issues them
    # one at a time all the same, so the loop below runs K single steps.
    steps_per_dispatch = int(train_config.get("steps_per_dispatch", 1))
    grad_accum = int(train_config.get("grad_accum", 1))
    if grad_accum > 1 and steps_per_dispatch > 1:
        raise ValueError("grad_accum and steps_per_dispatch are mutually "
                         "exclusive")
    accum_step = None
    if grad_accum > 1:
        from .train_state import train_accum_step_fn
        accum_step = train_accum_step_fn(loss_obj, dev,
                                         deep_metric_heads=show_deep,
                                         compute_dtype=torch.bfloat16)
        logger.info(f"grad_accum: {grad_accum}")
    elif steps_per_dispatch > 1:
        logger.info(f"steps_per_dispatch: {steps_per_dispatch} (the port "
                    "issues one step per batch: the same numbers)")
    eval_step = eval_step_fn(model)

    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(os.path.join(save_path, "logs"))
    except ImportError:   # TensorBoard is optional
        writer = None

    # ``async_checkpoint``: writes on a background thread
    # (``orbax_ckpt.py``); default the reference's synchronous file.
    async_writer = None
    if train_config.get("async_checkpoint"):
        from .orbax_ckpt import AsyncCheckpointWriter
        async_writer = AsyncCheckpointWriter()
        logger.info("async checkpointing enabled (a background thread)")
    ckpt_s = 0.0

    def save_ckpt(name: str, epoch: int) -> None:
        nonlocal ckpt_s
        t0 = time.perf_counter()
        kwargs = dict(epoch=epoch, best_train_dice=best_train_dice,
                      best_val_dice=best_val_dice,
                      scheduler_state=scheduler.state_dict())
        path = os.path.join(save_path, name + ".pth")
        if async_writer is not None:
            async_writer.save(path, model, optimizer, **kwargs)
        else:
            save_checkpoint(path, model, optimizer, **kwargs)
        ckpt_s += time.perf_counter() - t0

    prefetch_size = int(train_config.get("prefetch", 2))
    iteration = 0
    epochs = train_config["epochs"]

    # ``profile_dir``: a torch.profiler trace of dispatches 2-12 (the
    # first is the warm-up) of the first epoch, stopped early at the
    # epoch's end. On the card the stream is drained at both ends, so the
    # trace holds the device work of whole steps (3-12).
    profile_dir = train_config.get("profile_dir")
    prof = {"trace": None, "done": False}

    def maybe_profile(n_dispatch: int) -> None:
        if not profile_dir or prof["done"]:
            return
        if prof["trace"] is None and n_dispatch >= 2:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof["trace"] = start_trace(profile_dir)
        elif prof["trace"] is not None and n_dispatch >= 12:
            stop_profile()

    def stop_profile() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof["trace"].stop()
        prof.update(trace=None, done=True)
        logger.info(f"profiler trace written to {profile_dir}")

    def log_train_aux(aux_f, epoch, it_in_epoch, n_batches):
        msg = (f"train {epoch + 1}/{epochs} {it_in_epoch}/{n_batches} "
               f"Training Loss:{aux_f['loss']:.4f} "
               f"[FP:{aux_f.get('fp_rate', 0):.4f}, "
               f"FN:{aux_f.get('fn_rate', 0):.4f}, "
               f"IoU:{aux_f.get('iou', 0):.4f}, "
               f"Dice:{aux_f.get('dice', 0):.4f}]")
        for head in aux_f.get("deep", ()):
            # show_deep_metrics line format (utils/metric/metrics.py:18,24)
            msg += (f"\n[FP:{head['fp_rate']:.4f}, "
                    f"FN:{head['fn_rate']:.4f}, "
                    f"IoU:{head['iou']:.4f}, Dice:{head['dice']:.4f} "
                    f"pix:{int(head['pred_pix']):6}/"
                    f"{int(head['label_pix']):6}]")
        logger.info(msg)
        if writer is not None:
            writer.add_scalar("Training Loss", aux_f["loss"], iteration)
            writer.add_scalar("Training FP", aux_f.get("fp_rate", 0),
                              iteration)
            writer.add_scalar("Training FN", aux_f.get("fn_rate", 0),
                              iteration)
            writer.add_scalar("Training IOU", aux_f.get("iou", 0),
                              iteration)
            writer.add_scalar("Training Dice", aux_f.get("dice", 0),
                              iteration)

    # Loaders last: their threads stop in the ``finally`` below.
    num_workers = getattr(args, "num_workers", 4)
    # In-RAM decoded-volume cache (MONAI CacheDataset analogue): epochs
    # >= 2 skip NIfTI decode and the foreground crop, within a byte budget
    # (default 40% of host RAM).
    cache = bool(train_config.get("cache_dataset", True))
    cache_bytes = (int(train_config["cache_max_gb"] * (1 << 30))
                   if "cache_max_gb" in train_config else None)
    if cache:
        logger.info("dataset cache enabled "
                    f"(budget {cache_bytes or 'default 40% RAM'})")
    train_loader = PatchLoader(
        train_files, profile.modality_names,
        default_train_transform(
            patch_size, num_samples=2, rotate_prob=0.5,
            range_z=rotation_range_from_degrees(15),
            use_foreground_crop=profile.use_foreground_crop),
        batch_size=train_config["batch_size"], num_samples=2,
        num_workers=num_workers, shuffle=True,
        modal_index=modal_index, binary_label=profile.binary_label,
        cache=cache, cache_max_bytes=cache_bytes)
    val_loader = PatchLoader(
        val_files, profile.modality_names,
        default_val_transform(
            patch_size, num_samples=2,
            use_foreground_crop=profile.use_foreground_crop),
        batch_size=train_config["batch_size"], num_samples=2,
        num_workers=num_workers, shuffle=False,
        modal_index=modal_index, binary_label=profile.binary_label,
        cache=cache, cache_max_bytes=cache_bytes)

    try:
        for epoch in range(start_epoch, epochs):
            set_learning_rate(optimizer, scheduler.learning_rate(epoch))
            start = time.time()
            t_epoch = time.perf_counter()
            ckpt_s = 0.0
            totals = {"loss": 0.0, "fp_rate": 0.0, "fn_rate": 0.0,
                      "iou": 0.0, "dice": 0.0}
            n_batches = 0
            pending = None  # the previous dispatch's aux, in flight
            logger.info(f"\n*** Start Epoch {epoch + 1} Training ***\n")

            def flush(p):
                nonlocal n_batches, iteration
                aux_f = p.result()
                iteration += 1
                for k in totals:
                    totals[k] += aux_f.get(k, 0.0)
                log_train_aux(aux_f, epoch, n_batches, len(train_loader))
                n_batches += 1

            src = iter(_grouped(prefetch_to_device(
                train_loader, size=prefetch_size, device=dev), grad_accum))
            meter = ThroughputMeter()
            timer = _StepTimer(dev)
            n_dispatch = 0
            waits = []      # host seconds blocked on the loader, per batch
            while True:
                t0 = time.perf_counter()
                batch = next(src, None)
                waits.append(time.perf_counter() - t0)
                if batch is None:
                    break
                x, y = batch
                timer.mark()
                if x.dim() == 6:  # A micro-batches: ONE update, one log
                    state, aux = accum_step(state, x, y, generator)
                    meter.update(x.shape[0] * x.shape[1])
                else:
                    state, aux = step(state, x, y, generator)
                    meter.update(x.shape[0])
                timer.mark()
                n_dispatch += 1
                maybe_profile(n_dispatch)
                fetch = _AuxFetch(aux)
                if pending is not None:
                    flush(pending)
                pending = fetch
            if pending is not None:
                flush(pending)
            if prof["trace"] is not None:  # epoch shorter than the trace
                stop_profile()
            step_ms = timer.ms()
            t_loop = time.perf_counter() - t_epoch

            means = {k: v / max(n_batches, 1) for k, v in totals.items()}
            mean_dice = means["dice"]

            if epoch % train_config["save_model_interval"] == 0:
                save_ckpt(str(epoch), epoch)
            if mean_dice >= best_train_dice:
                logger.info(f"get new best dice {best_train_dice} -> "
                            f"{mean_dice}, save new 'train_best.pth'")
                best_train_dice = mean_dice
                save_ckpt("train_best", epoch)

            logger.info(
                f"training epoch {epoch + 1}: average "
                f"[FP:{means['fp_rate']:.4f}, FN:{means['fn_rate']:.4f}, "
                f"IoU:{means['iou']:.4f}, Dice:{mean_dice:.4f}] "
                f"loss {means['loss']:.4f} time {time.time() - start:.1f}s "
                f"({meter.rate():.1f} patches/s)")

            # Validation ----------------------------------------------
            t_val = time.perf_counter()
            ckpt_before_val = ckpt_s
            vn = 0
            if (epoch + 1) % train_config["val_interval"] == 0:
                logger.info(f"\n*** Start Epoch {epoch + 1} Validating "
                            "***\n")
                vtotals = None
                for xs, ys in val_loader:
                    xs, ys = device_put((xs, ys), dev)
                    pred, _ = eval_step(xs)
                    m = (segmentation_metrics(ys, pred)
                         if profile.binary_label else brats_dice(pred, ys))
                    # one copy to the host for the batch's metrics
                    vals = torch.stack(list(m.values())).cpu().tolist()
                    m = dict(zip(m, vals))
                    vtotals = (m if vtotals is None else
                               {k: vtotals[k] + m[k] for k in vtotals})
                    vn += 1
                if vn:
                    vmeans = {k: v / vn for k, v in vtotals.items()}
                    val_dice = vmeans.get("dice", vmeans.get("avg", 0.0))
                    logger.info(f"validation epoch {epoch + 1}: "
                                + " ".join(f"{k}:{v:.4f}"
                                           for k, v in vmeans.items()))
                    if writer is not None:
                        for k, v in vmeans.items():
                            writer.add_scalar(f"Val {k}", v, epoch)
                    scheduler.plateau_step(val_dice)
                    if val_dice >= best_val_dice:
                        logger.info(f"get new best dice {best_val_dice} -> "
                                    f"{val_dice}, save new 'val_best.pth'")
                        best_val_dice = val_dice
                        save_ckpt("val_best", epoch)
            # the val_best write counts as a checkpoint, not validation
            val_s = time.perf_counter() - t_val - (ckpt_s - ckpt_before_val)
            median = statistics.median(step_ms) if step_ms else 0.0
            span_kind = ("stream span, host issue + device"
                         if dev.type == "cuda" else "host")
            logger.info(
                f"epoch {epoch + 1} split: "
                f"{time.perf_counter() - t_epoch:.4f} s | steps "
                f"{len(step_ms)}, step median {median:.3f} ms "
                f"({span_kind}"
                f"), loop {t_loop:.4f} s, loader wait {sum(waits):.4f} s "
                f"(first batch {waits[0]:.4f} s), {meter.rate():.3f} "
                f"patches/s | checkpoints "
                f"{ckpt_s:.4f} s | validation {val_s:.4f} s ({vn} "
                f"batches)")
    finally:
        if async_writer is not None:
            async_writer.close()
        if writer is not None:
            writer.close()
        train_loader.close()
        val_loader.close()
    return {"best_train_dice": best_train_dice,
            "best_val_dice": best_val_dice,
            "save_path": save_path,
            "state": state}
