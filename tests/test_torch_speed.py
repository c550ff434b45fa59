"""The speed CLI (``veloxseg_torch.cli.speed_main``), its fenced timer
(``utils/benchmarking.py``) and its operation count (``utils/flops.py``) on
the CPU.

- The CLI at the micro config of ``tests/test_cli_e2e.py`` (with the three
  JLC branches every repo config has: the port has no single-kernel JLC
  form), its protocol shrunk as that test shrinks it: the JAX result keys,
  ``device == "cpu"``, a positive throughput, the printed lines, the
  parameter counts of the JAX CLI's formula (``model.init(train=False)``'s
  parameters, through ``jax.eval_shape``) for VeloxSeg and U-RWKV, and the
  registry's other models skipped.
- Without a card, asking for the card raises.
- Each kernel's operation count equals ``FlopCounterMode``'s count of its
  plain version, so that a forward counts the same on the card (kernels)
  and on the CPU (plain versions).
- ``find_max_batch_size`` stops at ``torch.cuda.OutOfMemoryError`` alone.
- The timer: the fence, the window's iteration counts and ``max_iters``,
  by counts (no rate thresholds).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from torch_port_helpers import normal
from veloxseg_torch.cli import speed_main
from veloxseg_torch.ops import fused_jlc, pwa_attention, wkv
from veloxseg_torch.utils import benchmarking
from veloxseg_torch.utils.flops import add_kernel_flops, count_flops

# tests/test_cli_e2e.py's micro VeloxSeg, with the branches (1, 3, 5)
MICRO = {"VeloxSeg": {
    "input_size": [16, 16, 16], "patch_size": 4, "in_ch": [1, 1],
    "n_classes": 2, "base_ch": 4, "attn_base_ch": 4,
    "conv_depths": [1, 1], "kernel_sizes": [1, 3, 5],
    "min_dim_group": [4, 4], "conv_expansion_factor": [2, 2],
    "depths": [1, 1],
    "min_big_window_sizes": [[2, 2, 2], [2, 2, 2]],
    "min_small_window_sizes": [[1, 1, 1], [1, 1, 1]],
    "min_dim_head": [4, 4], "scale_factors": [2, 2],
    "num_heads": [1, 1], "ffn_expansion_ratio": [2, 2],
    "spatial_dim": 3,
}, "U-RWKV": {"input_channel": 2, "num_classes": 2}, "NoSuchModel": {}}
SHAPE = (16, 16, 16, 2)


@pytest.fixture
def micro(tmp_path, monkeypatch):
    path = tmp_path / "models.json"
    path.write_text(json.dumps(MICRO))
    monkeypatch.setitem(speed_main.INPUT_SIZE, "AutoPETII", SHAPE)
    monkeypatch.setattr(speed_main, "T_TIMED", 0.3)
    monkeypatch.setattr(speed_main, "MAX_BS", 2)
    return str(path)


def _jax_params(name: str) -> int:
    """The JAX speed CLI's parameter count (``speed_main.py:60-66``): the
    leaves of ``model.init(..., train=False)["params"]``, by their
    shapes."""
    from veloxseg_tpu.models.registry import load_model
    model = load_model(name, MICRO)
    shapes = jax.eval_shape(
        lambda k1, k2, x: model.init({"params": k1, "dropout": k2}, x,
                                     train=False),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1),
        jnp.zeros((1, *SHAPE), jnp.float32))["params"]
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))


def test_cli_on_the_cpu(micro, capsys):
    results = speed_main.main(["--dataset", "AutoPETII", "--model_config",
                               micro, "--devices", "cpu"])
    out = capsys.readouterr().out
    assert [r["model"] for r in results] == ["VeloxSeg", "U-RWKV"]
    for r in results:
        assert set(r) == {"model", "throughput", "batch_size", "params",
                          "flops", "device"}
        assert r["device"] == "cpu" and r["throughput"] > 0
        assert r["batch_size"] == 2 and r["flops"] > 0
        assert r["params"] == _jax_params(r["model"]), r
        assert f"{r['model']} cpu {r['throughput']:.2f} images/s @ batch " \
               f"size 2" in out
        assert f"Params {r['params'] / 1e6} M" in out
        assert f"FLOPS: {r['flops'] / 1e9} G" in out
    assert "NoSuchModel: not implemented yet, skipping" in out
    assert out.count("Achieved: ") == 2


def test_cli_needs_the_card_unless_cpu_alone(micro):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for devices in ("default", "default,cpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            speed_main.main(["--dataset", "AutoPETII", "--model_config",
                             micro, "--model_list", "U-RWKV", "--devices",
                             devices])


def test_flops_count_a_bf16_forward_at_batch_1(micro):
    """The operation count of the CLI's forward is its batch-1 count, in
    bf16 as in fp32, and the kernels' hook adds to it."""
    from veloxseg_torch.models.registry import load_model
    model = load_model("VeloxSeg", MICRO, device="cpu")
    x = torch.from_numpy(normal((1, *SHAPE), 1))
    with torch.inference_mode():
        n32 = count_flops(model, x)
        n16 = count_flops(model.to(torch.bfloat16), x.to(torch.bfloat16))

        def plus_kernel(v):
            add_kernel_flops(1000)
            return model(v)
        nk = count_flops(plus_kernel, x.to(torch.bfloat16))
    assert n32 == n16 > 0 and nk == n16 + 1000
    add_kernel_flops(5)          # no count in progress: nothing to add to


def _library_flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", [(2, 1, 9, 4, 4, 54),
                                               (1, 2, 3, 16, 32, 27)])
def test_attention_flops_formula(b, h, n, c_qk, c_v, l):
    q, k = (torch.randn(b, h, n, c_qk, l) for _ in range(2))
    v, bias = torch.randn(b, h, n, c_v, l), torch.randn(h, l, l)
    assert pwa_attention.window_attention_flops(b, h, n, c_qk, c_v, l) == \
        _library_flops(pwa_attention.window_attention_plain, q, k, v, bias,
                       0.5)


@pytest.mark.parametrize("b,c,groups,e,shape", [(2, 16, 4, 3, (6, 6, 6)),
                                                (1, 8, 2, 2, (3, 5, 7))])
def test_jlc_flops_formulas(b, c, groups, e, shape):
    x = torch.randn(b, c, *shape)
    cg = c // groups
    ws = [torch.randn(c, cg, k, k, k) for k in (1, 3, 5)]
    bs = [torch.randn(c) for _ in ws]
    assert fused_jlc.jlc_stage1_flops(x, ws) == _library_flops(
        fused_jlc.jlc_stage1_plain, x, ws, bs, groups)
    w1, w2 = torch.randn(e * c, c, 1, 1, 1), torch.randn(c, e * c, 1, 1, 1)
    assert fused_jlc.jlc_stage2_flops(x, w1) == _library_flops(
        fused_jlc.jlc_stage2_plain, x, w1, torch.randn(e * c), w2,
        torch.randn(c))


def test_wkv_plain_version_counts_nothing():
    """K6 reports no operations: its plain version is elementwise."""
    k, v = torch.randn(2, 8, 4), torch.randn(2, 8, 4)
    assert _library_flops(wkv.wkv_plain, torch.randn(4), torch.randn(4), k,
                          v) == 0


def test_find_max_batch_size_stops_only_at_oom(monkeypatch):
    monkeypatch.setattr(speed_main, "MAX_BS", 16)
    seen = []

    def fwd(x):
        seen.append(x.shape[0])
        if x.shape[0] > 4:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return x.sum()
    args = ((3,), torch.bfloat16, torch.device("cpu"))
    assert speed_main.find_max_batch_size(fwd, *args) == 4
    assert seen == [1, 2, 4, 8]

    def first_oom(x):
        raise torch.cuda.OutOfMemoryError("out of memory")
    assert speed_main.find_max_batch_size(first_oom, *args) == 0

    def broken(x):
        if x.shape[0] == 2:
            raise RuntimeError("nvcc failed")
        return x.sum()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        speed_main.find_max_batch_size(broken, *args)
    assert speed_main.find_max_batch_size(lambda x: x.sum(), *args) == 16


def test_fence_returns_the_first_element():
    assert benchmarking.fence(torch.arange(8.0) + 3) == 3.0
    assert benchmarking.fence({"a": [torch.full((3,), 7.0,
                                                dtype=torch.bfloat16)]}) \
        == 7.0
    with pytest.raises(ValueError):
        benchmarking.fence([])


def test_timed_window_counts_and_max_iters():
    calls = []

    def dispatch():
        calls.append(1)
        return torch.ones(4)
    n, dt = benchmarking.timed_window(dispatch, seconds=30.0, probe_iters=3,
                                      max_iters=5)
    # two probe phases of 3, then the window
    assert n == 5 and len(calls) == 3 + 3 + 5 and dt > 0
    calls.clear()
    n, _ = benchmarking.timed_window(dispatch, seconds=0.0, probe_iters=2)
    assert n == 1 and len(calls) == 2 + 2 + 1


def test_median_rate_scales_with_units():
    ticks = iter(range(10 ** 6))
    # a clock that advances one second per reading: every window's time is
    # known, so the rate is exact
    mp = pytest.MonkeyPatch()
    mp.setattr(benchmarking.time, "perf_counter", lambda: float(next(ticks)))
    try:
        r = benchmarking.median_rate(lambda: torch.ones(2), 8.0, windows=3,
                                     seconds=100.0, max_iters=4)
    finally:
        mp.undo()
    # each window: 4 dispatches between two readings one second apart
    assert r == 8.0 * 4 / 1.0


def test_assert_in_order_returns_at_once_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    benchmarking._IN_ORDER_CHECKED = False
    benchmarking.assert_in_order()
    assert benchmarking._IN_ORDER_CHECKED
