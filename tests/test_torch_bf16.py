"""bf16 compute in the port against the JAX package on the CPU.

- Kernel twins: the bf16 plain versions of K2f and K2b (dropout 0 and 0.1)
  against the interpret-mode Pallas train kernels (``_train_fwd_pallas``,
  ``_train_bwd_pallas``) on bf16 q, k, v and dO; those of K4f and K4b
  against the interpret-mode Pallas stage-1 kernels of ``jlc_block``
  (``_k1_fwd``, ``_k1_bwd``, on the packed stream, so at even edges) on
  bf16 x and weights, and K4b's weight gradient against XLA's bf16 wgrad of
  each branch conv on the same dy. Every bf16 output: at least 99% of the
  elements bit for bit equal and every other within 1 bf16 ulp, but for at
  most 0.1% within 2^-8 of the tensor's largest magnitude
  (``torch_port_helpers.assert_bf16_match``); a twin that skips a rounding
  point fails that. dbias (fp32 on both sides) within 1e-4 of its scale.
- The TINY train step, every dropout 0, in bf16 (``train_step_fn``, and
  ``train_accum_step_fn`` over two batches) against the JAX
  ``_loss_grads_fn(compute_dtype=bfloat16)``, with attention through the
  interpret-mode Pallas kernels, run by ``tools/bf16_step_reference.py`` in
  a process of its own with XLA's excess precision off. The bound
  (``tools/chip_measure.STEP_BOUND``) comes from the JAX step's own
  bf16-to-fp32 distance (``chip_measure.step_distances``): the loss within
  0.5 of it; over all gradients together within 1.5 of it from the JAX bf16
  step and at least 0.5 of it away from the JAX fp32 step (the port does
  compute in bf16); each tensor within 4 of its own distance plus one bf16
  ulp of its norm (and a floor of 1e-5 of the largest gradient per element
  for the gradients that are 0 in exact arithmetic). The two frameworks'
  bf16 backwards round in other places, so their gradients' rounding noise
  is nearly independent: the port's gradients lie about as far from the JAX
  bf16 ones as those from the fp32 ones (``tools/bf16_step_reference.py
  --report``: 0.95); the loss, a forward quantity, agrees far closer
  (0.06). A port that ignores ``compute_dtype`` lies 1.0 from JAX in its
  loss and ~0 from the fp32 step in its gradients, and fails.
- The reconstruction target of a bf16 step is the input rounded to bf16 (a
  spy on the loss), and ``run_train`` builds its steps with
  ``compute_dtype=torch.bfloat16``.

About 110 s alone, most of it the reference's two JAX compiles, which run
beside the kernel twins.
"""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.make_fixtures import make_autopet_fixtures
from torch_port_helpers import (TINY_JSON, assert_bf16_match, cf, normal,
                                tiny_train_config)
from veloxseg_torch.ops import fused_jlc as port_jlc
from veloxseg_torch.ops import pwa_attention as port_attn
from veloxseg_torch.train import train_state as tts
from veloxseg_torch.train.loss import CompositeLoss
from veloxseg_tpu.ops import fused_jlc as jax_jlc
from veloxseg_tpu.ops import packed_conv
from veloxseg_tpu.ops.pwa_attention import (_train_bwd_pallas,
                                            _train_fwd_pallas)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bf16_step_reference as ref  # noqa: E402

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    """The JAX reference steps, started with this file's first test so that
    their compiles run beside the kernel twins."""
    path = tmp_path_factory.mktemp("bf16_step") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "bf16_step_reference.py"),
         "--out", str(path)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(jax_reference_process):
    proc, path = jax_reference_process
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out.decode(errors="replace")[-4000:]
    return ref.load_reference(str(path))


def _t(a) -> torch.Tensor:
    """A JAX array (bf16 or fp32) as a torch tensor of the same dtype."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(BF16) if a.dtype == jnp.bfloat16 else t


# ---------------------------------------------------------------------------
# K2f and K2b: (B, h, N, Cqk, Cv, L), N below the Pallas kernel's window
# block, so that it pads no window and numbers the dropout ids as the port

@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", [(2, 2, 7, 4, 8, 54),
                                               (1, 2, 3, 8, 8, 128)])
def test_train_attention_bf16_twins_match_pallas(b, h, n, c_qk, c_v, l, p):
    q, k, do = (normal(s, i) for i, s in enumerate(
        [(b, h, n, c_qk, l), (b, h, n, c_qk, l), (b, h, n, c_v, l)]))
    v = normal((b, h, n, c_v, l), 3)
    bias = normal((h, l, l), 4, 0.5)
    scale = 1.0 / np.sqrt(c_qk)
    seed = [[4321, 1]]
    q16, k16, v16, do16 = (jnp.asarray(a).astype(jnp.bfloat16)
                           for a in (q, k, v, do))
    seed_j = jnp.asarray(seed, jnp.int32)
    out_j = _train_fwd_pallas(q16, k16, v16, jnp.asarray(bias), seed_j,
                              scale, p, interpret=True)
    grads_j = _train_bwd_pallas(q16, k16, v16, jnp.asarray(bias), seed_j,
                                do16, scale, p, interpret=True)
    qt, kt, vt, dot = (_t(a) for a in (q16, k16, v16, do16))
    bt, st = torch.from_numpy(bias), torch.tensor(seed[0], dtype=torch.int32)
    out, lse, out32 = port_attn.window_attention_train_fwd(
        qt, kt, vt, bt, st, scale, p)
    assert lse.dtype == out32.dtype == torch.float32
    assert_bf16_match(out, _t(out_j), "K2f out")
    grads = port_attn.window_attention_train_bwd(qt, kt, vt, bt, st, dot,
                                                 scale, p, out32, lse)
    for name, g, r in zip(("dq", "dk", "dv"), grads, grads_j):
        assert_bf16_match(g, _t(r), f"K2b {name}")
    db = _t(grads_j[3])
    assert grads[3].dtype == db.dtype == torch.float32
    torch.testing.assert_close(grads[3], db, rtol=1e-4,
                               atol=1e-4 * float(db.abs().max()))


# ---------------------------------------------------------------------------
# K4f and K4b: (C, groups, edge), B = 2; the 8³ one at AutoPET-II's L0
# widths (16 channels, 4 a group)

@pytest.mark.parametrize("c,groups,s", [(16, 4, 8), (8, 2, 6)])
def test_jlc_stage1_bf16_twins_match_pallas(c, groups, s):
    cg = c // groups
    ks = (1, 3, 5)
    x = normal((2, s, s, s, c), 41)
    g = normal((2, s, s, s, c), 42)
    ws = [normal((k, k, k, cg, c), 43 + k, (2.0 / (cg * k ** 3)) ** 0.5)
          for k in ks]                                        # DHWIO
    bs = [normal((c,), 50 + k, 0.3) for k in ks]
    x16, g16 = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    ws16 = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
    xp = packed_conv.pack_s2d(x16)
    wp = packed_conv.packed_kernel(list(zip(ks, ws16)), c, groups)
    wp = wp.reshape(27, 8 * c, 3 * 8 * c).astype(jnp.bfloat16)
    out_j = packed_conv.unpack_s2d(
        jax_jlc._k1_fwd(xp, wp, 3, interpret=True), c)
    dyp = jax_jlc._k1_bwd(xp, wp, packed_conv.pack_s2d(g16), 3,
                          interpret=True)
    half = (2,) + (s // 2,) * 3
    dy_j = [packed_conv.unpack_s2d(
        dyp[..., j * 8 * c:(j + 1) * 8 * c].reshape(*half, 8 * c), c)
        for j in range(3)]
    # XLA's bf16 wgrad of each branch conv on the Pallas kernel's dy
    dw_j = [jax.vjp(lambda w, k=k: lax.conv_general_dilated(
        x16, w, (1, 1, 1), [(k // 2, k // 2)] * 3,
        feature_group_count=groups,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")), w16)[1](d)[0]
        for k, w16, d in zip(ks, ws16, dy_j)]

    xt, gt = (cf(a).contiguous().to(BF16) for a in (x, g))
    wt = [torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (4, 3, 0, 1, 2)))).to(BF16) for w in ws]
    bt = [torch.from_numpy(b).to(BF16) for b in bs]

    def cl16(a):                       # channels-last JAX bf16 → port
        return torch.movedim(_t(a), -1, 1)

    out1 = port_jlc.jlc_stage1(xt, wt, bt, groups)
    assert_bf16_match(out1, cl16(out_j), "K4f out1")
    dy, _ = port_jlc.jlc_stage1_bwd(xt, wt, gt, groups)
    dy_ref = torch.stack([cl16(d) for d in dy_j])
    for j in range(3):
        assert_bf16_match(dy[j], dy_ref[j], f"K4b dy k={ks[j]}")
    dws = port_jlc.jlc_branch_wgrad(xt, dy_ref, wt, groups)
    for k, got, r in zip(ks, dws, dw_j):
        r = torch.from_numpy(np.ascontiguousarray(np.transpose(
            np.asarray(r.astype(jnp.float32)), (4, 3, 0, 1, 2)))).to(BF16)
        assert_bf16_match(got, r, f"K4b dW k={k}")


# ---------------------------------------------------------------------------
# The TINY train step in bf16 against the JAX step

@pytest.mark.parametrize("case", ["step", "accum"])
def test_bf16_step_matches_jax(reference, case):
    from chip_measure import step_bound_violations
    d = ref.distances(ref.port_step(case, BF16),
                      ref.reference_case(reference, case))
    assert not step_bound_violations(d), d


@pytest.mark.parametrize("dtype", [BF16, None])
def test_reconstruction_target_is_the_input_as_computed(dtype):
    """``sr_labels`` is the input rounded to the compute dtype, in fp32
    (``train_state.py:55-59``): bf16-rounded in a bf16 step, the input
    itself in fp32."""
    model, tcfg = ref.port_model()
    seen = {}

    class Spy(CompositeLoss):
        def __call__(self, output, labels, sr_labels):
            seen["sr"] = sr_labels.detach().clone()
            seen["rec"] = output[-4].dtype
            return super().__call__(output, labels, sr_labels)

    state = tts.create_train_state(model, torch.optim.SGD(
        model.parameters(), lr=0.0))
    x, y = ref.batch(2)
    xt = torch.from_numpy(x)
    tts.train_step_fn(Spy("VeloxSeg", ref.TRAIN_CFG,
                          num_modal=tcfg.num_modalities), "cpu",
                      with_metrics=False,
                      compute_dtype=dtype)(state, xt,
                                           torch.from_numpy(y).long(), None)
    assert seen["sr"].dtype == torch.float32
    if dtype is None:
        assert seen["rec"] == torch.float32
        assert torch.equal(seen["sr"], xt)
    else:
        assert seen["rec"] == BF16
        assert torch.equal(seen["sr"], xt.to(BF16).float())
        assert not torch.equal(seen["sr"], xt)
    # the master weights stay fp32 and their gradients are fp32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters() if p.grad is not None)


class _Built(Exception):
    """Stops ``run_train`` once it has built its steps."""


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_run_train_steps_in_bf16(tmp_path, monkeypatch, grad_accum):
    """``run_train`` builds its step (and its accumulation step) with
    ``compute_dtype=torch.bfloat16``, as the JAX trainer passes
    ``jnp.bfloat16`` (``trainer.py:297-348``)."""
    import veloxseg_torch.train.trainer as ttrainer
    built = []

    def spy(name, inner, last):
        def build(*a, **kw):
            built.append((name, kw.get("compute_dtype")))
            if last:
                raise _Built
            return inner(*a, **kw)
        return build

    monkeypatch.setattr(ttrainer, "train_step_fn", spy(
        "step", ttrainer.train_step_fn, grad_accum == 1))
    monkeypatch.setattr(tts, "train_accum_step_fn", spy(
        "accum", tts.train_accum_step_fn, True))
    globs = make_autopet_fixtures(str(tmp_path / "data"), n_cases=3)
    tc = dict(tiny_train_config("AutoPETII", globs, 2.5e-4),
              save_path=str(tmp_path / "save"), grad_accum=grad_accum)
    args = argparse.Namespace(dataset_name="AutoPETII", model_name="VeloxSeg",
                              checkpoint_path=None, num_workers=1,
                              model_index=None, select_modal=None)
    with pytest.raises(_Built):
        ttrainer.run_train(args, tc, {"VeloxSeg": TINY_JSON}, device="cpu")
    want = [("step", BF16)] + ([("accum", BF16)] if grad_accum > 1 else [])
    assert built == want
