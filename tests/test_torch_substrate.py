"""The port's host-side substrate against the reference: the data pipeline's
``iterate``/``host_batch``, fault tolerance (``StragglerDetector``,
``HostMonitor``, ``plan_elastic``), the dry-run cell table (``SHAPES``,
``cell_is_runnable``), ``linear_warmup_cosine``, the quantizer presets and
the serving weights' ``threshold=``.

Held to: batches equal; the reference's own substrate cases
(``tests/test_substrate.py``) replayed on the port; the cell table equal
over all 10 archs x 4 shapes; the schedule bit-equal to the eager
reference except where numpy's and XLA's fp32 ``cos`` part by an ulp;
presets equal as configs; weight bytes equal at two thresholds.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.core import quantizer as j_quantizer  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_cosine as j_cosine  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import weights as j_weights  # noqa: E402
from repro.train import fault_tolerance as j_ft  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quantizer  # noqa: E402
from repro_torch.core.optimizers import linear_warmup_cosine  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.serve import weights  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
def test_iterate_and_host_batch_equal_reference(num_hosts):
    cfg = pipeline.DataConfig(vocab_size=512, seq_len=16, global_batch=8, seed=3)
    jcfg = j_pipeline.DataConfig(vocab_size=512, seq_len=16, global_batch=8, seed=3)
    ours = pipeline.SyntheticLM(cfg)
    ref = j_pipeline.SyntheticLM(jcfg)
    for host in range(num_hosts):
        got = list(itertools.islice(ours.iterate(2, host, num_hosts), 3))
        want = list(itertools.islice(ref.iterate(2, host, num_hosts), 3))
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    for step in (0, 5):
        a, b = pipeline.host_batch(ours, step), j_pipeline.host_batch(ref, step)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_straggler_detector_flags_slow_host():
    for mod in (ft, j_ft):
        det = mod.StragglerDetector(threshold=1.5, window=8, patience=2)
        flagged = []
        for _ in range(8):
            for h in range(4):
                det.record(h, 1.0 if h != 2 else 3.0)
            flagged.append(det.stragglers())
        assert flagged[-1] == [2]
        assert flagged[0] == []  # patience: one slow check is not enough
    # the same decisions step by step on a noisy trace
    rng = np.random.default_rng(0)
    dets = [m.StragglerDetector(threshold=1.3, window=4, patience=3) for m in (ft, j_ft)]
    for _ in range(20):
        times = rng.uniform(0.8, 1.2, 5) * np.where(rng.random(5) < 0.3, 2.0, 1.0)
        outs = []
        for det in dets:
            for h, t in enumerate(times):
                det.record(h, float(t))
            outs.append(det.stragglers())
        assert outs[0] == outs[1]
        assert dets[0].medians() == dets[1].medians()


def test_host_monitor_deadline_and_elastic_plan():
    for mod in (ft, j_ft):
        t = [0.0]
        mon = mod.HostMonitor([0, 1, 2], deadline_s=10.0, clock=lambda: t[0])
        t[0] = 5.0
        mon.beat(0)
        mon.beat(1)
        t[0] = 12.0
        assert mon.dead_hosts() == [2]
        assert mon.alive() == [0, 1]
        plan = mod.plan_elastic(mon.alive(), latest_checkpoint=40)
        assert plan.num_hosts == 2 and plan.restore_step == 40
        assert plan.host_index(1) == 1
        mon.beat(2, at=11.0)
        assert mon.dead_hosts() == []
        with pytest.raises(RuntimeError, match="below minimum"):
            mod.plan_elastic([3], latest_checkpoint=None, min_hosts=2)
    assert ft.plan_elastic([5, 1, 3], 7) == ft.ElasticPlan(hosts=[1, 3, 5], restore_step=7)


def test_cell_table_equals_reference():
    assert tuple(configs.ARCHS) == tuple(j_configs.ARCHS)
    assert configs.LONG_CONTEXT_ARCHS == j_configs.LONG_CONTEXT_ARCHS
    assert {k: tuple(v.__dict__.values()) for k, v in configs.SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in j_configs.SHAPES.items()}
    for arch, shape in itertools.product(configs.ARCHS, configs.SHAPES):
        assert configs.cell_is_runnable(arch, shape) == j_configs.cell_is_runnable(arch, shape)


@pytest.mark.parametrize("final_frac", [0.1, 0.0])
def test_linear_warmup_cosine_equals_reference(final_frac):
    """Bit-equal to the eager reference wherever numpy's fp32 ``cos`` and
    XLA's agree; where they part (by 1 ulp, never more), within that ulp
    carried through ``lr * (ff + (1 - ff) / 2 * (1 + cos))`` plus 1 ulp of
    the result (near the end of the decay ``1 + cos`` cancels, so one ulp of
    ``cos`` is several of the result)."""
    lr, warmup, total = 3e-4, 10, 200
    ours = linear_warmup_cosine(lr, warmup, total, final_frac)
    ref = j_cosine(lr, warmup, total, final_frac)
    f = np.float32
    parted = 0
    for s in range(0, 230, 3):
        got, want = ours(s), np.float32(ref(jnp.int32(s)))
        t = min(max((f(s) - f(warmup)) / f(total - warmup), f(0)), f(1))
        x = f(np.pi) * t
        c_np, c_xla = np.cos(x), np.float32(jnp.cos(x))
        assert abs(int(c_np.view(np.int32)) - int(c_xla.view(np.int32))) <= 1
        if c_np == c_xla or s < warmup:
            assert got.view(np.int32) == want.view(np.int32), s
        else:
            parted += 1
            bound = lr * (1 - final_frac) * 0.5 * abs(float(c_np) - float(c_xla))
            assert abs(float(got) - float(want)) <= bound + float(np.spacing(want)), s
    assert parted < 20
    # the warmup is exact and the end holds the floor
    assert ours(warmup // 2) == np.float32(ref(jnp.int32(warmup // 2)))
    assert ours(total + 5) == np.float32(ref(jnp.int32(total + 5)))


def test_quantizer_presets_equal_reference():
    fields = ("bits", "normalization", "block_size", "mapping", "signed", "stochastic_rounding",
              "threshold")
    for name in ("B2048_DE", "B128_DE", "B128_DE0", "RANK1_LINEAR"):
        a, b = getattr(quantizer, name), getattr(j_quantizer, name)
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields], name
        assert a.name == b.name


@pytest.mark.parametrize("threshold", [weights.DEFAULT_THRESHOLD, 1 << 14])
def test_weights_threshold_bytes_equal_reference(threshold):
    assert weights.DEFAULT_THRESHOLD == j_weights.DEFAULT_THRESHOLD
    cfg = j_configs.reduced_config("internlm2-1.8b")
    jparams, _ = j_init(jax.random.PRNGKey(0), cfg)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    for mode in ("bf16", "q4"):
        got = weights.weight_report(params, mode, threshold=threshold)
        want = j_weights.weight_report(jparams, mode, threshold=threshold)
        for key in ("total_serve_bytes", "total_bf16_bytes", "quantized_leaves", "n_leaves"):
            assert got[key] == want[key], (mode, key)
        prepared = weights.prepare_params(params, mode, threshold=threshold)
        kept = [k for k, v in prepared.items()
                if isinstance(v, torch.Tensor) and v.dtype == torch.float32]
        assert len(kept) == got["n_leaves"] - got["quantized_leaves"] if mode == "q4" else True
        nbytes = sum(v.nbytes() if isinstance(v, quantizer.QuantizedTensor)
                     else v.numel() * v.element_size() for v in prepared.values())
        assert nbytes == want["total_serve_bytes"], mode
