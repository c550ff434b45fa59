"""The port's bf16 eval forward (the speed CLI's) against the JAX package on
the CPU.

- Kernel twins: the bf16 plain versions of K1 (``window_attention``'s CPU
  path), K5f and K5b against the interpret-mode Pallas kernels on bf16
  operands (``window_attention_pallas`` here; ``_k2_fwd`` and ``_k2_bwd``
  in the reference process below, where XLA keeps every bf16 rounding, on
  the packed parity stream, so at even edges, their block-diagonal weight
  gradients folded over the 8 parities in fp32 and rounded once, as the
  port rounds them), each by ``torch_port_helpers.assert_bf16_match``; a
  copy of each twin that skips one rounding point fails that rule. K6's
  wrapper on bf16 operands against ``wkv_scan`` on the same.
- The norms U-RWKV runs, in bf16, bit for bit against the JAX ones run op
  by op (each bf16 operation rounds): ``BatchNormNoTrack`` (the port's
  computed its statistics in bf16 until this was fixed) and the last-axis
  ``LayerNorm`` (``torch.nn.LayerNorm`` rounds once, after its affine, and
  does not match).
- The TINY VeloxSeg and a 32³ U-RWKV eval forward in bf16, as the speed CLI
  runs them, against the JAX bf16 forward (``tools/bf16_eval_reference.py``
  in a process of its own, XLA's excess precision off, the Pallas kernels in
  interpret mode), to ``chip_measure.FORWARD_BOUND``: a bound relative to
  JAX's own bf16-to-fp32 distance, two-sided, which the port run in fp32
  fails.

About 40 s alone, most of it the reference's JAX compiles, which run beside
the twins.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import assert_bf16_match, normal
from veloxseg_torch.models.zoo import common as port_common
from veloxseg_torch.ops import fused_jlc as port_jlc
from veloxseg_torch.ops import pwa_attention as port_attn
from veloxseg_torch.ops import wkv as port_wkv
from veloxseg_tpu.models.zoo import common as jax_common
from veloxseg_tpu.nn import norms as jax_norms
from veloxseg_tpu.ops.pwa_attention import window_attention_pallas
from veloxseg_tpu.ops.wkv import wkv_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bf16_eval_reference as ref  # noqa: E402
from chip_measure import FORWARD_BOUND, forward_distances  # noqa: E402

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    """The JAX reference forwards, started with this file's first test so
    that their compiles run beside the twins."""
    path = tmp_path_factory.mktemp("bf16_eval") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "bf16_eval_reference.py"),
         "--out", str(path)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(jax_reference_process):
    proc, path = jax_reference_process
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out.decode(errors="replace")[-4000:]
    return ref.load_reference(str(path))


def _t(a) -> torch.Tensor:
    """A JAX bf16 array as a bf16 torch tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(BF16)


def _fails(fn):
    with pytest.raises(AssertionError):
        fn()


# ---------------------------------------------------------------------------
# K1: (B, h, N, Cqk, Cv, L) at AutoPET-II's L0 and L1 widths and a ragged L

@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", [(2, 1, 9, 4, 4, 54),
                                               (1, 2, 3, 8, 8, 128),
                                               (2, 4, 2, 16, 32, 27)])
def test_attention_bf16_twin_matches_pallas(b, h, n, c_qk, c_v, l):
    q, k, v = (jnp.asarray(normal(s, i)).astype(jnp.bfloat16)
               for i, s in enumerate([(b, h, n, c_qk, l)] * 2
                                     + [(b, h, n, c_v, l)]))
    bias = normal((h, l, l), 4, 0.5)
    scale = 1.0 / np.sqrt(c_qk)
    out_j = _t(window_attention_pallas(q, k, v, jnp.asarray(bias), scale,
                                       block_windows=2, interpret=True))
    qt, kt, vt = (_t(a) for a in (q, k, v))
    bt = torch.from_numpy(bias)
    n0 = port_attn.window_attention.launches_bf16
    got = port_attn.window_attention(qt, kt, vt, bt, scale)
    assert port_attn.window_attention.launches_bf16 == n0  # the twin ran
    assert got.dtype == BF16
    assert_bf16_match(got, out_j, "K1")

    def weights_rounded():        # window_attention_xla's rounding point
        s = torch.einsum("bhncl,bhncm->bhnlm", qt.float(), kt.float())
        w = torch.softmax(s * scale + bt[None, :, None], dim=-1).to(BF16)
        return torch.einsum("bhnlm,bhncm->bhncl", w.float(),
                            vt.float()).to(BF16)
    _fails(lambda: assert_bf16_match(weights_rounded(), out_j, "K1 copy"))


# ---------------------------------------------------------------------------
# K5f and K5b: the cases of ``bf16_eval_reference.STAGE2_CASES``, against
# the interpret-mode Pallas kernels run by the reference process

def _cf(a: np.ndarray) -> torch.Tensor:
    """Channels-last fp32 array → channels-first bf16 tensor."""
    return torch.movedim(torch.from_numpy(a), -1, 1).contiguous().to(BF16)


@pytest.mark.parametrize("case", ref.STAGE2_CASES)
def test_jlc_stage2_bf16_twins_match_pallas(reference, case):
    c, e, _ = case
    hid = e * c
    want = reference["k5"][case]
    x, g, w1, b1, w2, b2 = ref.stage2_case(*case)
    xt, gt = _cf(x), _cf(g)
    # the port's weight shapes: w1 (E·C, C, 1, 1, 1), w2 (C, E·C, 1, 1, 1)
    w1t = torch.from_numpy(w1.T.copy()).reshape(hid, c, 1, 1, 1).to(BF16)
    w2t = torch.from_numpy(w2.T.copy()).reshape(c, hid, 1, 1, 1).to(BF16)
    b1p, b2p = torch.from_numpy(b1).to(BF16), torch.from_numpy(b2).to(BF16)
    out_j = _cf(want["out"])
    out = port_jlc.jlc_stage2(xt, w1t, b1p, w2t, b2p)
    assert out.dtype == BF16
    assert_bf16_match(out, out_j, "K5f out")
    refs = {"dx": _cf(want["dx"]),
            "dw1": torch.from_numpy(want["dw1"].T.copy()).to(BF16),
            "db1": torch.from_numpy(want["db1"]).to(BF16),
            "dw2": torch.from_numpy(want["dw2"].T.copy()).to(BF16),
            "db2": torch.from_numpy(want["db2"]).to(BF16)}
    grads = port_jlc.jlc_stage2_bwd_plain(xt, w1t, b1p, w2t, gt)
    for name, got in zip(("dx", "dw1", "db1", "dw2", "db2"), grads):
        assert got.dtype == BF16
        assert_bf16_match(got, refs[name].reshape(got.shape), f"K5b {name}")

    def z2_not_rounded():         # K5f without z2 = bf16(W2·h + b2)
        z = port_jlc.instance_norm(xt.float()).to(BF16).float()
        z = F.conv3d(z, w1t.float(), b1p.float())
        z = port_jlc._gelu_as(z, BF16).float()
        z = F.conv3d(z, w2t.float(), b2p.float())
        return (xt.float() + z).to(BF16)
    _fails(lambda: assert_bf16_match(z2_not_rounded(), out_j, "K5f copy"))

    def dz1_not_rounded():        # K5b's dx without dz1b = bf16(dz1)
        b = xt.shape[0]
        xf = xt.float()
        mean, rstd = port_jlc._plane_stats(xf)
        yhat = ((xf - mean) * rstd).reshape(b, c, -1)
        z1pb = (torch.einsum("ec,bcs->bes", w1t.float().reshape(hid, c),
                             yhat.to(BF16).float())
                + b1p.float()[:, None]).to(BF16).float()
        g3 = gt.float().reshape(b, c, -1)
        dz1 = (torch.einsum("ce,bcs->bes", w2t.float().reshape(c, hid), g3)
               * port_jlc._gelu_grad(z1pb))
        dz = torch.einsum("ec,bes->bcs", w1t.float().reshape(hid, c), dz1)
        din = port_jlc._in_backward(dz, yhat, rstd.reshape(b, c, 1))
        return (g3 + din.to(BF16).float()).to(BF16).reshape(xt.shape)
    _fails(lambda: assert_bf16_match(dz1_not_rounded(), refs["dx"],
                                     "K5b copy"))


# ---------------------------------------------------------------------------
# K6: U-RWKV's arguments (w = decay / T, u = first / T) on bf16 operands

def test_wkv_bf16_matches_wkv_scan():
    from veloxseg_torch.models.zoo.urwkv import _fancy_init
    b, t, c = 2, 27, 16
    decay, first, *_ = _fancy_init(c)
    args16 = [jnp.asarray(a).astype(jnp.bfloat16)
              for a in (decay / t, first / t, normal((b, t, c), 61, 2.0),
                        normal((b, t, c), 62))]
    ref_j = _t(wkv_scan(*args16))
    got = port_wkv.wkv(*(_t(a) for a in args16))
    assert got.dtype == BF16
    assert_bf16_match(got, ref_j, "K6 bf16")


# ---------------------------------------------------------------------------
# The norms: bf16, bit for bit against the JAX ones run op by op

def _jax_eager(module, params, x):
    """``module.apply`` without jit: every bf16 operation rounds."""
    with jax.disable_jit():
        return module.apply({"params": params}, x)


def test_batch_norm_bf16_matches_jax():
    x = normal((2, 4, 4, 4, 8), 71, 3.0) + 5.0      # channels-last
    w, b = normal((8,), 72, 0.5) + 1.0, normal((8,), 73, 0.5)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    ref_j = _t(_jax_eager(jax_common.BatchNormNoTrack(),
                          {"scale": jnp.asarray(w).astype(jnp.bfloat16),
                           "bias": jnp.asarray(b).astype(jnp.bfloat16)},
                          x16))
    bn = port_common.BatchNormNoTrack(8).to(BF16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        got = bn(torch.movedim(_t(x16), -1, 1))
    assert torch.equal(torch.movedim(got, 1, -1), ref_j)


def test_layer_norm_bf16_matches_jax():
    x = normal((2, 27, 16), 74, 3.0) + 2.0
    w, b = normal((16,), 75, 0.5) + 1.0, normal((16,), 76, 0.5)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    ref_j = _t(_jax_eager(jax_norms.LayerNorm(),
                          {"scale": jnp.asarray(w).astype(jnp.bfloat16),
                           "bias": jnp.asarray(b).astype(jnp.bfloat16)},
                          x16))
    ln = port_common.LayerNorm(16).to(BF16)
    library = torch.nn.LayerNorm(16, eps=1e-6).to(BF16)
    with torch.no_grad():
        for m in (ln, library):
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
        assert torch.equal(ln(_t(x16)), ref_j)
        # one rounding after the affine: not the JAX package's
        assert not torch.equal(library(_t(x16)), ref_j)


# ---------------------------------------------------------------------------
# The bf16 eval forwards against JAX's

@pytest.mark.parametrize("name", ["veloxseg", "urwkv"])
def test_bf16_eval_forward_matches_jax(reference, name):
    r16, r32 = reference[name]["bf16"], reference[name]["fp32"]
    got = ref.port_forward(name, reference, BF16)
    assert got.shape == r16.shape and np.isfinite(got).all()
    d = forward_distances(got, r16, r32)
    assert d["to_bf16"] <= FORWARD_BOUND["to_bf16"], d
    assert d["to_fp32"] >= FORWARD_BOUND["to_fp32"], d
    # the bound is two-sided: the forward in fp32 fails it
    d32 = forward_distances(ref.port_forward(name, reference, torch.float32),
                            r16, r32)
    assert d32["to_fp32"] < FORWARD_BOUND["to_fp32"], d32
    assert d32["to_bf16"] > FORWARD_BOUND["to_bf16"], d32


def test_bf16_eval_attention_gets_an_fp32_bias(monkeypatch):
    """A bf16 model's position bias reaches K1 in fp32, as the JAX package
    casts it at the Pallas call (``pwa_attention.py:130``): K1's bf16 form
    takes an fp32 bias and raises on another."""
    from veloxseg_torch.nn import pwa as port_pwa
    seen = []
    inner = port_pwa.window_attention

    def spy(q, k, v, bias, scale):
        seen.append((q.dtype, bias.dtype))
        return inner(q, k, v, bias, scale)
    monkeypatch.setattr(port_pwa, "window_attention", spy)
    model = ref.port_veloxseg().to(BF16)
    with torch.inference_mode():
        model(torch.from_numpy(ref.veloxseg_input()[:1]).to(BF16))
    assert seen and all(s == (BF16, torch.float32) for s in seen), seen
