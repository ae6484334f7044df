"""Stochastic rounding at the train-step level in the port, the six
statistical checks of the reference's ``tests/test_sr_train.py``.

Step 1 of a fresh run compresses the first moments with SR; step 2 consumes
the dequantized states, so after two steps the params carry one round of
quantization noise. Averaged over many base keys, the 2-step params must
converge to the rounding-free (fp32-state) trajectory: SR is unbiased, so
the mean's bias shrinks like 1/sqrt(N) while one run's deviation does not.
Also: the key reaches the quantizer through ``TrainState ->
build_train_step -> compressed()`` (different keys give different codes),
the stream replays bit for bit under the same key, the fused kernel route
(its plain version on the CPU) agrees with the unfused route in
distribution, and without a key SR-configured runs are deterministic.

The model is the port's own (``init_model`` from seed 0, torch's draws);
every seed and key is fixed, so each check is deterministic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import LayerSpec, ModelConfig, init_model  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402

torch.set_num_threads(1)

CFG = ModelConfig(name="sr-lm", num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,
                  head_dim=32, d_ff=128, vocab_size=256, blocks=(LayerSpec("dense", 0),))
# d_ff 256 makes the mlp w1/w3 leaves (1, 64, 256) kernel-eligible; attention
# and embed stay unfused, so a step runs both routes side by side
KCFG = ModelConfig(name="sr-kernel-lm", num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,
                   head_dim=32, d_ff=256, vocab_size=256, blocks=(LayerSpec("dense", 0),))
W1 = "decoder/0/sub0/mlp/w1"

_DATA = SyntheticLM(DataConfig(256, 16, 8, seed=4))
_BATCHES = [{k: torch.from_numpy(v) for k, v in _DATA.batch_at(t).items()} for t in range(2)]


def _run_two_steps(opt, key, cfg=CFG):
    """Two train steps from the seed-0 model (a fresh copy: the state holds
    the model's own tensors)."""
    model = init_model(cfg, seed=0, device="cpu")
    step = build_train_step(model, opt)
    state = make_train_state(model, opt, key=key)
    for b in _BATCHES:
        state, _ = step(state, b)
    return state


def _embed(state):
    return state.params["embed"].detach().numpy().copy()


def _state_leaves(state):
    out = [p.detach() for p in state.params.values()]
    for leaf in _leaves(state.opt_state):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, QuantizedTensor) else [leaf]
    return out


def _assert_replays(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def sr_runs():
    """(fp32-state embed, SR embeds over 48 keys, RTN embed)."""
    ref = _embed(_run_two_steps(make_optimizer("sgdm", 5e-2), None))
    opt_sr = make_optimizer("sgdm4bit", 5e-2)
    embeds = [_embed(_run_two_steps(opt_sr, sr.PRNGKey(i))) for i in range(48)]
    rtn = _embed(_run_two_steps(make_optimizer("sgdm4bit", 5e-2, stochastic_rounding=False),
                                None))
    return ref, embeds, rtn


def test_sr_mean_update_converges_to_rounding_free(sr_runs):
    ref, embeds, _ = sr_runs
    single_dev = float(np.mean([np.abs(e - ref).mean() for e in embeds]))
    assert single_dev > 0, "SR produced no quantization noise: key not plumbed?"
    mean_bias = float(np.abs(np.mean(embeds, axis=0) - ref).mean())
    # unbiased: averaging 48 keys shrinks the error ~7x; 0.3 leaves slack
    assert mean_bias < 0.3 * single_dev, (mean_bias, single_dev)


def test_sr_mean_beats_round_to_nearest(sr_runs):
    """RTN carries a systematic rounding bias the SR average does not."""
    ref, embeds, rtn = sr_runs
    mean_bias = float(np.abs(np.mean(embeds, axis=0) - ref).mean())
    rtn_bias = float(np.abs(rtn - ref).mean())
    assert mean_bias < rtn_bias, (mean_bias, rtn_bias)


def test_sr_keys_decorrelate_and_reproduce():
    opt = make_optimizer("adamw4bit", 3e-3, stochastic_rounding=True)
    s_a = _run_two_steps(opt, sr.PRNGKey(0))
    s_b = _run_two_steps(opt, sr.PRNGKey(1))
    s_a2 = _run_two_steps(opt, sr.PRNGKey(0))
    m_a = s_a.opt_state.states[0].inner.m["embed"]
    m_b = s_b.opt_state.states[0].inner.m["embed"]
    assert isinstance(m_a, QuantizedTensor)
    # different base keys: different SR noise in the packed codes
    assert not torch.equal(m_a.codes, m_b.codes)
    # the same base key: the whole TrainState replays bit for bit
    _assert_replays(s_a, s_a2)


def test_kernel_route_sr_statistically_matches_unfused():
    """Training through the fused SR route must agree with the unfused
    ``compressed()`` SR path in distribution: the two mean trajectories
    over 16 base keys coincide much more tightly than single runs scatter,
    on a kernel-eligible leaf."""
    def sweep(use_kernel):
        opt = make_optimizer("adamw4bit", 3e-3, stochastic_rounding=True,
                             use_kernel=use_kernel)
        return [_run_two_steps(opt, sr.PRNGKey(i), KCFG).params[W1].detach().numpy().copy()
                for i in range(16)]

    fused, unfused = sweep(True), sweep(False)
    scatter = float(np.mean([np.abs(e - fused[0]).mean() for e in fused[1:]]))
    assert scatter > 0, "kernel-route SR produced no noise: key not plumbed?"
    gap = float(np.abs(np.mean(fused, axis=0) - np.mean(unfused, axis=0)).mean())
    assert gap < 0.5 * scatter, (gap, scatter)


def test_kernel_route_sr_decorrelates_and_replays():
    """Fused-route SR noise: different base keys give different packed
    codes; the same base key replays the whole TrainState bit for bit."""
    opt = make_optimizer("production4bit", 3e-3)
    s_a = _run_two_steps(opt, sr.PRNGKey(0), KCFG)
    s_b = _run_two_steps(opt, sr.PRNGKey(1), KCFG)
    s_a2 = _run_two_steps(opt, sr.PRNGKey(0), KCFG)
    m_leaf = s_a.opt_state.states["4bit"].states[0].inner.m[W1]
    m_leaf_b = s_b.opt_state.states["4bit"].states[0].inner.m[W1]
    assert isinstance(m_leaf, QuantizedTensor)
    assert not torch.equal(m_leaf.codes, m_leaf_b.codes)
    _assert_replays(s_a, s_a2)


def test_sr_noop_without_key():
    """No key in the TrainState: deterministic round-to-nearest (two
    SR-configured runs without keys are bit-identical)."""
    opt = make_optimizer("adamw4bit", 3e-3, stochastic_rounding=True)
    _assert_replays(_run_two_steps(opt, None), _run_two_steps(opt, None))
