"""Shared helpers of the ``test_torch_*`` files: the port (``veloxseg_torch``)
held against the JAX package on the CPU, same weights, same inputs.

Weights: the port module is built, its parameters are overwritten with
seeded numpy values, and its ``state_dict()`` is mapped to JAX params with
``veloxseg_tpu.interop.torch_import.convert_state_dict`` (the JAX
``init`` is never run: it is slow unjitted).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from veloxseg_torch.core.config import VeloxSegConfig as TorchConfig

# The suite runs in several xdist workers on one host: PyTorch's default
# of one intra-op thread per core in every worker oversubscribes the cores
# many times over and slows the JAX tests that share them.
torch.set_num_threads(min(torch.get_num_threads(), 2))

TINY = dict(
    input_size=(32, 32, 32),
    patch_size=4,
    in_ch=(1, 1),
    n_classes=2,
    base_ch=8,
    attn_base_ch=8,
    depths=(1, 1, 1, 1),
    min_big_window_sizes=((2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 1, 1)),
)
# tests/test_model.py:76-77: one modality with four channels
BRATS_TINY = dict(TINY, in_ch=(4,), n_classes=4)
# tests/test_model.py:94-97: anisotropic input and windows
HECKTOR_TINY = dict(
    TINY,
    input_size=(64, 64, 32),
    min_big_window_sizes=((4, 4, 2), (4, 4, 2), (2, 2, 1), (2, 2, 1)),
)


def configs(d: dict):
    """(port config, JAX config) of one config dict."""
    from veloxseg_tpu.core.config import VeloxSegConfig as JaxConfig
    return TorchConfig(**d), JaxConfig(**d)


def randomize_(module: torch.nn.Module, seed: int, scale: float = 0.3
               ) -> torch.nn.Module:
    """Overwrite every parameter with seeded N(0, scale²) values (biases,
    norms and position tables included, so nothing sits at its init)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) * scale)
                .astype(np.float32)))
    return module


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def cl(x: torch.Tensor) -> np.ndarray:
    """Channels-first torch tensor → channels-last numpy array."""
    return np.ascontiguousarray(torch.movedim(x, 1, -1).detach().numpy())


def cf(x: np.ndarray) -> torch.Tensor:
    """Channels-last numpy array → channels-first torch tensor."""
    return torch.movedim(torch.from_numpy(np.asarray(x, np.float32)), -1, 1)


def dense(conv_w: torch.Tensor) -> np.ndarray:
    """1×1 conv ``(O, I, 1, 1, 1)`` → JAX Dense kernel ``(I, O)``."""
    w = conv_w.detach().numpy()
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def dhwio(conv_w: torch.Tensor) -> np.ndarray:
    """Conv ``(O, I/g, k, k, k)`` → JAX DHWIO kernel."""
    return np.ascontiguousarray(
        np.transpose(conv_w.detach().numpy(), (2, 3, 4, 1, 0)))


def cuda_or_skip() -> torch.device:
    """The card for a ``cuda``-marked test; skip where there is none.
    Called inside a test, never at import, so every worker collects the
    same tests."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in units in the last place:
    adjacent bf16 values are 1 apart, +0 and −0 are equal."""
    def key(t):
        i = t.detach().cpu().contiguous().view(torch.int16).to(torch.int32)
        mag = i & 0x7FFF
        return torch.where(i < 0, -mag, mag)
    return (key(got) - key(ref)).abs()


def assert_bf16_match(got: torch.Tensor, ref: torch.Tensor, what: str,
                      share: float = 0.99) -> None:
    """The rule a bf16 kernel form and its bf16 plain twin (or the Pallas
    kernel) are held to: both bf16, at least ``share`` of the elements bit
    for bit equal, every other within 1 bf16 ulp. The two sum in other
    orders in fp32 before one rounding, so an fp32 sum near a rounding
    boundary may round the other way; a twin that skips a rounding point
    is off by an ulp at far more elements. Two cases move an element by
    more than its own ulp, at a few elements: a sum that cancels near 0
    (its ulp is finer than the fp32 resolution of the sum), and a flip of a
    value rounded inside the function (K4b's normalized value before the
    GELU's gradient) that the rest of the function then scales. At most
    0.1% of the elements may lie more than 1 ulp apart, each within 1 ulp
    of the tensor's largest magnitude (2^-8 of it)."""
    assert got.dtype == ref.dtype == torch.bfloat16, (what, got.dtype,
                                                      ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not got.numel():
        return
    d = bf16_ulps(got, ref)
    equal = float((d == 0).double().mean())
    far = d > 1
    g, r = got.detach().cpu().double(), ref.detach().cpu().double()
    gap = float((g - r).abs()[far].max()) if bool(far.any()) else 0.0
    floor = 2.0 ** -8 * float(r.abs().max())
    assert (equal >= share and float(far.double().mean()) <= 1e-3
            and gap <= floor), (
        f"{what}: {equal:.4%} bit-equal, {int(far.sum())} elements more "
        f"than 1 ulp apart, by up to {gap:.3e} (floor {floor:.3e})")


# ---------------------------------------------------------------------------
# Whole-volume driver parity: both CLIs over the same NIfTI fixtures and
# checkpoint file, the CSVs and masks compared.

# tests/test_cli_e2e.py's TINY model config, as the JSON the CLIs read
TINY_JSON = {
    "input_size": [32, 32, 32], "patch_size": 4, "in_ch": [1, 1],
    "n_classes": 2, "base_ch": 8, "attn_base_ch": 8,
    "conv_depths": [1, 1, 1, 1], "kernel_sizes": [1, 3, 5],
    "min_dim_group": [4, 8, 8, 16], "conv_expansion_factor": [3, 3, 2, 2],
    "depths": [1, 1, 1, 1],
    "min_big_window_sizes": [[2, 2, 2], [2, 2, 2], [2, 2, 2], [1, 1, 1]],
    "min_small_window_sizes": [[1, 1, 1]] * 4,
    "min_dim_head": [4, 8, 8, 16], "ffn_expansion_ratio": [3, 3, 2, 2],
    "num_heads": [1, 2, 2, 4], "proj_drop": 0.1, "conv_drop": 0.1,
    "spatial_dim": 3,
}
# masks may differ only where JAX's top-2 logit margin is below this
TIE_MARGIN = 1e-4


@contextlib.contextmanager
def jax_compile_cache(path):
    """JAX's persistent compilation cache in ``path`` for the block: the
    JAX driver compiles the same init and tile programs on every run, and
    a run's second compile of one program then reads it back."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    for k, v in zip(keys, (str(path), 0.5, 0)):
        jax.config.update(k, v)
    cc.reset_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        cc.reset_cache()


def driver_workspace(root, dataset: str, models: dict, patch, globs: dict):
    """Write the three JSON configs the CLIs read, one set per side
    (``jax``, ``port``) with its results under ``root/<side>/``; the last
    40% of the cases are the test split (train 0.4, val 0.2). Returns
    ``{side: {"flags": [config flags], "metric": dir, "pred": dir}}``."""
    import json
    import os
    flags = {}
    for side in ("jax", "port"):
        base = os.path.join(str(root), side)
        os.makedirs(base, exist_ok=True)
        configs_ = {
            "train.json": {"patch_size": {dataset: list(patch)},
                           "train_rate": 0.4, "val_rate": 0.2,
                           "dataset_path": {dataset: globs}},
            "models.json": models,
            "test.json": {
                "result_metric_path": os.path.join(base, "metric"),
                "result_pred_path": os.path.join(base, "prediction"),
                "sliding_window": {"overlap": 0.25}},
        }
        for name, data in configs_.items():
            with open(os.path.join(base, name), "w") as f:
                json.dump(data, f)
        flags[side] = dict(
            flags=["--dataset_name", dataset,
                   "--train_config", os.path.join(base, "train.json"),
                   "--model_config", os.path.join(base, "models.json"),
                   "--test_config", os.path.join(base, "test.json")],
            metric=os.path.join(base, "metric"),
            pred=os.path.join(base, "prediction"))
    return flags


def run_both_drivers(ws: dict, args, stitch_threshold=None):
    """``veloxseg_tpu.cli.test_main.main`` and
    ``veloxseg_torch.cli.test_main.main(... --device cpu)`` on the same
    arguments, in the workspace ``ws`` of :func:`driver_workspace`. Spies
    record what each driver computed: the blended logits, the masks it
    handed to its metrics and whether the host summed the tiles.
    Returns ``{side: {"rows", "csv" (the text, or None), "log", "masks",
    "logits", "stitched"}}``."""
    import glob
    import os
    import pathlib

    import pytest
    import veloxseg_tpu.infer.driver as jdrv
    import veloxseg_torch.infer.driver as tdrv
    from veloxseg_torch.cli.test_main import main as port_main
    from veloxseg_tpu.cli.test_main import main as jax_main

    out = {s: {"masks": [], "logits": [], "stitched": []}
           for s in ("jax", "port")}

    def spy_window(mod, side):
        inner = mod.sliding_window_inference

        def wrapped(*a, **kw):
            res = inner(*a, **kw)
            out[side]["stitched"].append(bool(kw.get("cpu_accumulate")))
            out[side]["logits"].append(np.asarray(res[0]))
            return res
        return wrapped

    def spy_metric(mod, name, side, pred_arg):
        inner = getattr(mod, name)

        def wrapped(*a, **kw):
            out[side]["masks"].append(np.asarray(
                a[pred_arg].cpu() if side == "port" else a[pred_arg])[0])
            return inner(*a, **kw)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for mod, side in ((jdrv, "jax"), (tdrv, "port")):
            mp.setattr(mod, "sliding_window_inference",
                       spy_window(mod, side))
            mp.setattr(mod, "segmentation_metrics",
                       spy_metric(mod, "segmentation_metrics", side, 1))
            mp.setattr(mod, "brats_dice", spy_metric(mod, "brats_dice",
                                                     side, 0))
            if stitch_threshold is not None:
                mp.setattr(mod, "CPU_STITCH_THRESHOLD", stitch_threshold)
        for side, fn, extra in (("jax", jax_main, []),
                                ("port", port_main, ["--device", "cpu"])):
            for f in glob.glob(os.path.join(ws[side]["metric"], "*")):
                os.remove(f)
            rows = fn(ws[side]["flags"] + list(args) + extra)
            out[side]["rows"] = (rows.to_dict("records") if side == "jax"
                                 else rows)
            csvs = glob.glob(os.path.join(ws[side]["metric"], "*.csv"))
            out[side]["csv"] = (pathlib.Path(csvs[0]).read_text() if csvs
                                else None)
            logs = glob.glob(os.path.join(ws[side]["metric"], "*.log"))
            out[side]["log"] = pathlib.Path(logs[0]).read_text()
    return out


def read_csv(text: str):
    """(header, rows as lists of str) of a metrics CSV's text."""
    import csv
    lines = list(csv.reader(text.splitlines()))
    return lines[0], lines[1:]


def top2_margin(logits: np.ndarray) -> np.ndarray:
    """Top-1 minus top-2 logit per voxel (channels last)."""
    s = np.sort(logits, axis=-1)
    return s[..., -1] - s[..., -2]


def assert_masks_agree(jax_mask, port_mask, logits,
                       margin: float = TIE_MARGIN) -> int:
    """Identical masks but where JAX's top-2 logit margin is below
    ``margin``; returns the mismatch count."""
    assert jax_mask.shape == port_mask.shape == logits.shape[:-1]
    diff = np.asarray(jax_mask) != np.asarray(port_mask)
    margins = top2_margin(logits)[diff]
    assert (margins < margin).all(), (
        f"{int(diff.sum())} voxels differ, margins up to {margins.max()}")
    return int(diff.sum())


def assert_logits_agree(jax_logits, port_logits, rel: float) -> None:
    """Blended logits within ``rel`` of their scale (the model's forward
    tolerance against JAX: ``test_torch_model.py``, ``test_torch_urwkv.py``)."""
    scale = float(np.abs(jax_logits).max())
    np.testing.assert_allclose(port_logits, jax_logits, rtol=1e-4,
                               atol=rel * scale)


def assert_csvs_agree(jax_csv: str, port_csv: str, masks_equal) -> None:
    """Same columns in the same order and the same row names; metrics
    within 1e-4 absolute; HD95 within 1e-4 relative for the rows whose
    masks are identical (``masks_equal[i]``). ``time`` differs."""
    jh, jrows = read_csv(jax_csv)
    ph, prows = read_csv(port_csv)
    assert ph == jh
    assert [r[0] for r in prows] == [r[0] for r in jrows]
    for jr, pr, same in zip(jrows, prows, masks_equal):
        for col, a, b in zip(jh, jr, pr):
            if col in ("name", "time"):
                continue
            assert (a == "") == (b == ""), (col, a, b)     # NaN both
            if a == "":
                continue
            a, b = float(a), float(b)
            if col.startswith("hd95"):
                if same:
                    assert abs(a - b) <= 1e-4 * abs(a), (col, a, b)
            else:
                assert abs(a - b) <= 1e-4, (col, a, b)


# ---------------------------------------------------------------------------
# Weights after AdamW steps, against a reference run from the same start.

def assert_adamw_weights_close(got: dict, ref: dict, grad_max: dict,
                               lr: float, steps: int) -> dict:
    """Hold the weights ``got`` after ``steps`` AdamW steps against the
    reference's ``ref``, element by element, split by the reference's
    gradients (``grad_max``: per key, each element's largest |gradient|
    over the steps), as ``test_torch_train_step.py`` splits tensors. Adam
    scales a gradient of rounding noise up to a step of up to lr, of
    either sign on each side, so a noise element is held to
    2·steps·lr·1.1 and every other element to 0.25·lr. Noise: every
    element of a tensor whose gradient is at most 1e-5 of the model's
    largest (biases in front of an InstanceNorm, a single-voxel level),
    and in the other tensors each element whose gradient is at most 1e-4
    of its tensor's largest, the gradient tests' relative tolerance (taps
    that reach only zero padding, elements whose sign that tolerance does
    not fix). Returns the counts of noise and real elements."""
    assert set(got) == set(ref)
    g_all = max(float(g.max()) for g in grad_max.values())
    assert g_all > 0.0
    n_noise = n_real = 0
    for k, r in ref.items():
        err = (got[k].detach().cpu().double() - r.double()).abs()
        g = grad_max.get(k)
        if g is None:           # not a parameter: never updated
            assert float(err.max()) == 0.0, k
            continue
        g = g.double()
        g_max = float(g.max())
        noise = (torch.ones_like(g, dtype=torch.bool)
                 if g_max <= 1e-5 * g_all else g <= 1e-4 * g_max)
        bound = torch.where(noise, 2.0 * steps * lr * 1.1, 0.25 * lr)
        worst = int((err - bound).argmax())
        assert bool((err <= bound).all()), (
            k, float(err.flatten()[worst]), float(bound.flatten()[worst]),
            float(g.flatten()[worst]))
        n_noise += int(noise.sum())
        n_real += int((~noise).sum())
    return {"noise": n_noise, "real": n_real}


# ---------------------------------------------------------------------------
# Whole-trainer parity: both ``run_train``s resume from one JAX checkpoint.

def tiny_train_config(dataset: str, globs: dict, lr: float) -> dict:
    """A train config over the fixtures ``globs`` at 32³ patches: the
    60/20/20 split, batch_size 2, 3 epochs, validation and checkpoints
    every epoch, adamw at ``lr`` with 1 warmup epoch, then cosine."""
    return {
        "dataset_path": {dataset: globs},
        "patch_size": {dataset: [32, 32, 32]},
        "train_rate": 0.6, "val_rate": 0.2, "batch_size": 2, "epochs": 3,
        "val_interval": 1, "save_model_interval": 1,
        "optimizer": {"optimizer_type": "adamw",
                      "optimizer_args": {"lr": lr, "weight_decay": 0.01}},
        "warmup_scheduler": {"enabled": True, "warmup_epochs": 1},
        "train_scheduler": {"scheduler_type": "cosine_annealing",
                            "scheduler_args": {"epochs": 10,
                                               "min_lr": 1e-6}},
        "deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
        "Feature_Loss_weight": 2.0, "show_deep_metric": True,
    }


def jax_resume_checkpoint(path, model_json: dict, seed: int, lr: float):
    """Write a JAX training ``.ckpt`` of epoch 0 at ``path``: seeded port
    weights mapped to JAX params and an adamw state (the JAX package's
    optimizer) after one optax step from seeded gradients. Returns the
    path as a string."""
    import jax
    import jax.numpy as jnp
    import optax
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    from veloxseg_tpu.interop.torch_import import convert_state_dict
    from veloxseg_tpu.train import checkpoint as jck
    from veloxseg_tpu.train import optim as joptim
    model, _ = build_veloxseg(model_json, device="cpu")
    randomize_(model, seed=seed, scale=0.2)
    params = jax.tree_util.tree_map(jnp.array,
                                    convert_state_dict(model.state_dict()))
    tx = joptim.build_optimizer("adamw", {"lr": lr, "weight_decay": 0.01})
    opt_state = tx.init(params)
    rng = np.random.default_rng(seed + 1)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.01), params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    jck.save_checkpoint(str(path), params, opt_state, epoch=0,
                        best_train_dice=0.0, best_val_dice=0.0,
                        scheduler_state={"plateau_scale": 1.0,
                                         "best": None, "bad_epochs": 0})
    return str(path)


def run_both_trainers(root, dataset: str, model_config: dict,
                      train_config: dict, ckpt: str):
    """``veloxseg_tpu.train.trainer.run_train`` and the port's ``run_train``
    (``device="cpu"``), both forced to step in fp32 by replacing each
    trainer module's ``train_step_fn`` (both trainers step in bf16), each
    resuming from ``ckpt`` with its results under
    ``root/<side>/save``; both steps record each iteration's loss, and the
    JAX step each element's largest |gradient| over the run, read from
    optax's first moment (adamw's ``mu_t = b1·mu_{t-1} + (1 - b1)·g_t``,
    b1 0.9, taken in float64 from the fp32 moments). Returns ``{side:
    run_train's dict plus "log" (the log's text) and "losses"}``, and
    ``"jax_grad_max"``: port key → tensor."""
    import argparse
    import os

    import jax
    import pytest
    from flax import serialization
    import veloxseg_torch.train.trainer as ttrainer
    import veloxseg_tpu.train.trainer as jtrainer
    from veloxseg_torch.interop.jax_params import optimizer_state_from_jax
    from veloxseg_tpu.train import train_state as jts

    losses = {"jax": [], "port": []}
    grad_max = {}

    def first_moments(state):
        st = optimizer_state_from_jax(
            serialization.to_state_dict(jax.device_get(state.opt_state)),
            jax.device_get(state.params))
        return {k: v["exp_avg"].double() for k, v in st.items()}

    def recording(side, inner):
        def step(state, x, y, key):
            before = first_moments(state) if side == "jax" else None
            state, aux = inner(state, x, y, key)
            losses[side].append(float(aux["loss"]))
            if before is not None:
                for k, mu in first_moments(state).items():
                    g = ((mu - 0.9 * before[k]) / 0.1).abs()
                    grad_max[k] = (torch.maximum(grad_max[k], g)
                                   if k in grad_max else g)
            return state, aux
        return step

    def jax_fp32_step(loss_obj, compute_dtype=None, with_metrics=True,
                      deep_metric_heads=False):
        return recording("jax", jts.train_step_fn(
            loss_obj, compute_dtype=None, with_metrics=with_metrics,
            deep_metric_heads=deep_metric_heads))

    port_step_fn = ttrainer.train_step_fn
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "train_step_fn", jax_fp32_step)
        mp.setattr(ttrainer, "train_step_fn", lambda *a, **kw: recording(
            "port", port_step_fn(*a, **dict(kw, compute_dtype=None))))
        for side, fn, kw in (("jax", jtrainer.run_train, {}),
                             ("port", ttrainer.run_train,
                              {"device": "cpu"})):
            args = argparse.Namespace(
                dataset_name=dataset, model_name="VeloxSeg",
                checkpoint_path=ckpt, num_workers=2, model_index=None,
                select_modal=None, mesh=None, distributed=None)
            tc = dict(train_config,
                      save_path=os.path.join(str(root), side, "save"))
            res = fn(args, tc, model_config, **kw)
            log = [f for f in os.listdir(res["save_path"])
                   if f.endswith(".log")]
            with open(os.path.join(res["save_path"], log[0])) as f:
                res["log"] = f.read()
            res["losses"] = losses[side]
            out[side] = res
    out["jax_grad_max"] = grad_max
    return out
