"""The tensor-parallel mesh step on the archs that
``tests/test_torch_tp_train.py`` and ``tests/test_torch_tp_archs.py`` do
not train: reduced whisper-large-v3 (encoder and decoder attention, the
decoder's cross-attention over the encoder's output, a tied head),
qwen2-vl-2b (embeds input, M-RoPE, a tied head), hymba-1.5b (attention and
SSM heads on one norm, both head-parallel), xlstm-125m (mLSTM and sLSTM
head-parallel, the sLSTM block's MLP mlp-parallel), mixtral-8x7b
(attention split, its 4 reduced experts expert-parallel, the router
gathered) and qwen3-4b
(q/k norms), each on (1, 2), 2 steps of production4bit with SR from
``init_model(seed=0)`` (``torch_mesh_worker``'s ``tp_step``, one world of
2 for all six, started before the one-process runs here).

Held to: the placement (which leaves split); the losses bit-equal on both
ranks; the recorded collective bytes equal to ``MeshStep.reckon``'s, call
for call; the losses within 1e-5 of the port's one-process run in fp32
compute (the partial sums add in another order) and within 1e-4 in bf16
compute (the column-parallel inputs' bf16 gradients summed over the pair
reach the 4-bit update: 2.2e-5 at most measured on a CPU, qwen3-4b's
second loss).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402

ARCHS = ("whisper-large-v3", "qwen2-vl-2b", "hymba-1.5b", "xlstm-125m", "mixtral-8x7b",
         "qwen3-4b")
# the split leaves (their names inside a block, or top-level) of each
SPLIT = {
    "whisper-large-v3": {"embed", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "self/wq",
                         "self/wk", "self/wv", "self/wo", "cross/wq", "cross/wk", "cross/wv",
                         "cross/wo", "mlp/w1", "mlp/w2"},
    "qwen2-vl-2b": {"embed", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1", "mlp/w2",
                    "mlp/w3"},
    "hymba-1.5b": {"embed", "head", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1",
                   "mlp/w2", "mlp/w3", "ssm_in", "ssm_dt", "ssm_dt_bias", "ssm_B", "ssm_C",
                   "ssm_A_log", "ssm_D", "ssm_out"},
    "xlstm-125m": {"embed", "head", "mlp/w1", "mlp/w2", "mlp/w3", "w_in", "wq", "wk", "wv",
                   "w_if", "b_if", "w_out", "w_gates", "r_gates"},
    "mixtral-8x7b": {"embed", "head", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "moe/w1",
                     "moe/w2", "moe/w3"},
    "qwen3-4b": {"embed", "head", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1",
                 "mlp/w2", "mlp/w3"},
}


def _batches(arch):
    """Two batches of 4 x 16 (whisper: and 24 frames; qwen2-vl: embeds and
    text M-RoPE positions in place of tokens)."""
    cfg = reduced_config(arch)
    rng = np.random.default_rng(0)
    out = []
    for t in range(2):
        b = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4)).batch_at(t)
        if arch == "whisper-large-v3":
            b["frames"] = rng.standard_normal((4, 24, cfg.d_model)).astype(np.float32)
        if arch == "qwen2-vl-2b":
            b = {"embeds": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32),
                 "positions": np.stack([np.tile(np.arange(16), (4, 1))] * 3),
                 "labels": b["labels"]}
        out.append(b)
    return out


def _params(arch):
    model = init_model(reduced_config(arch), seed=0, device="cpu")
    return {k: v.detach().numpy() for k, v in named_params(model).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tasks = {a: {"kind": "tp_step", "arch": a, "meshes": [(1, 2)], "lr": 1e-3, "sr_seed": 0,
                 "params": _params(a), "batches": _batches(a), "fp32": True} for a in ARCHS}
    return worker.start(2, tasks, str(tmp_path_factory.mktemp("tp_every_arch")))


@pytest.fixture(scope="module")
def one_process(world):
    out = {}
    for arch in ARCHS:
        for dtype in (torch.bfloat16, torch.float32):
            with worker._compute_dtype(dtype):
                model = init_model(reduced_config(arch), seed=0, device="cpu")
                opt = make_optimizer("production4bit", 1e-3)
                st = make_train_state(model, opt, key=sr.PRNGKey(0))
                out[arch, dtype] = worker._run_losses(build_train_step(model, opt), st,
                                                      _batches(arch))
    return out


@pytest.fixture(scope="module")
def results(world, one_process):
    ranks = worker.collect(world)
    return {a: [r[a][(1, 2)] for r in ranks] for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_split_leaves(arch, results):
    names = {k.split("/", 3)[-1] if "/" in k else k for k in results[arch][0]["split"]}
    assert names == SPLIT[arch], names


@pytest.mark.parametrize("arch", ARCHS)
def test_trains_as_one_process(arch, results, one_process):
    ranks = results[arch]
    got = ranks[0]["losses"]
    for rank, r in enumerate(ranks):
        assert r["losses"] == got and r["fp32"] == ranks[0]["fp32"], rank
        result_bytes, calls = r["reckoned"]
        for stats, recorded in zip(r["stats_bytes"], r["recorded"]):
            assert stats == result_bytes > 0 and sorted(recorded) == sorted(calls), (arch, rank)
    fp32 = [x for x, _ in ranks[0]["fp32"]]
    want, want32 = one_process[arch, torch.bfloat16], one_process[arch, torch.float32]
    print(f"{arch} (1, 2): losses {got} (one process {want}); fp32 compute {fp32} "
          f"(one process {want32})")
    np.testing.assert_allclose(fp32, want32, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
