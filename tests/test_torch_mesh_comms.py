"""The port's gradient collectives on a gloo world of 4 processes against
the reference (``torch_mesh_worker``; a ``FileStore`` in ``tmp_path``, one
thread per rank). The reference's side runs in the pytest process on the 8
host devices ``tests/conftest.py`` forces. Held to:

* ``quantized_all_reduce`` (int4, SR): the same bits on every rank, equal
  to the host oracle of ``tests/test_comms.py`` (each rank's
  ``dequantize(quantize(x_r))`` with ``fold_in(key, r)`` uniforms, summed in
  rank order) and to the reference's ``quantized_all_reduce`` under
  ``shard_map`` at the same size; SR unbiased (the mean over 16 keys at
  less than half the error of one);
* ``reduce_grads`` (int4 and int8, SR): bit-identical on (2, 2), (4, 1) and
  without a mesh, and bit-equal to the reference's.

Also here, the single-process cases of ``tests/test_torch_comms.py``:
``CommsConfig``, the wire accounting, ``reduce_grads``' threshold and RTN;
and the shared-memory transport's chunked rounds against gloo's own
(``collectives.open_host_slots`` at its least slot).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as JP  # noqa: E402

from repro.comms import (  # noqa: E402
    CommsConfig as JCommsConfig,
    quantized_all_reduce as j_all_reduce,
    reduce_grads as j_reduce_grads,
    wire_report as j_wire_report,
)
from repro.core.quantizer import dequantize as j_dequantize, quantize as j_quantize  # noqa: E402
from repro.kernels.sr import STREAM_GRAD, tensor_uniforms  # noqa: E402
from repro_torch.comms import (  # noqa: E402
    CommsConfig,
    format_wire_table,
    grad_comm_key,
    GRAD_COMM_KEY_DOMAIN,
    GRAD_COMM_MODES,
    leaf_wire_bytes,
    mode_totals,
    reduce_grads,
    wire_report,
)
from repro_torch.comms.collectives import HOST_MIN_BYTES  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.quantizer import quantize  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, LayerSpec, ModelConfig, named_params  # noqa: E402
from repro_torch.train.train_loop import build_train_step  # noqa: E402
from test_torch_comms import _grads, _jgrads  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

AXES = {"embed": ("vocab", "embed"), "w": ("embed", "mlp"), "bias": ("embed",)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _x():
    return np.random.default_rng(1).standard_normal((4, 16, 128), dtype=np.float32)


def _grads_np():
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((256, 64), dtype=np.float32),
            "w": rng.standard_normal((128, 128), dtype=np.float32),
            "bias": rng.standard_normal((64,), dtype=np.float32)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tasks = {
        "allreduce": {"kind": "allreduce", "x": _x(),
                      "qcfg": CommsConfig(mode="int4").quant_config(), "key": sr.PRNGKey(11),
                      "n_keys": 16},
        **{f"reduce_{mode}": {"kind": "reduce", "grads": _grads_np(), "axes": AXES, "mode": mode,
                              "key": sr.PRNGKey(7), "meshes": [(2, 2), (4, 1)]}
           for mode in ("int4", "int8")},
        "slots": {"kind": "slots"},
    }
    return worker.spawn(4, tasks, str(tmp_path_factory.mktemp("world4")))


def test_quantized_all_reduce_matches_host_oracle_and_reference(world4):
    x = _x()
    outs = [r["allreduce"]["oracle_key"] for r in world4]
    for r in range(1, 4):  # every rank holds the same reduced value
        assert torch.equal(outs[0], outs[r])
    qcfg = JCommsConfig(mode="int4").quant_config()
    key = jax.random.PRNGKey(11)
    deqs = []
    for r in range(4):  # the host oracle of tests/test_comms.py
        u = tensor_uniforms(jax.random.fold_in(key, r), (16, 128), STREAM_GRAD)
        deqs.append(j_dequantize(j_quantize(jnp.asarray(x[r]), qcfg, uniforms=u)))
    oracle = np.asarray(jnp.sum(jnp.stack(deqs), axis=0))
    np.testing.assert_array_equal(_bits(outs[0].numpy()), _bits(oracle))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("data",))

    # eager, as tests/test_comms.py runs it: jit reorders the dequantize-sum
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=JP("data"), out_specs=JP("data"),
                       check_vma=False)
    def reduced(xs):
        return j_all_reduce(xs[0], qcfg, "data", key=key)[None]

    ref = np.asarray(reduced(jnp.asarray(x)))
    for r in range(4):
        np.testing.assert_array_equal(_bits(outs[0].numpy()), _bits(ref[r]))


def test_host_slots_chunked_rounds_equal_gloo(world4):
    """Through slots of ``HOST_MIN_BYTES``, an all-gather of three slots and
    more and an all-to-all of a slot and more a piece take several rounds;
    their results equal gloo's own transport's bit for bit, over the world
    and over a group of two ranks; every rank gathers the same; no slot file
    is left in ``/dev/shm``."""
    ranks = [r["slots"] for r in world4]
    for r, res in enumerate(ranks):
        assert res["chunk"] == HOST_MIN_BYTES
        assert res["x_bytes"] > 3 * res["chunk"] and res["piece_bytes"] > res["chunk"]
        assert sorted(res["equal"]) == sorted(
            ["gather", "exchange"] + (["pair_gather", "pair_exchange"] if r in (0, 2) else []))
        assert all(res["equal"].values()), (r, res["equal"])
        assert torch.equal(res["shm"]["gather"], ranks[0]["shm"]["gather"])
        assert res["left"] == []
    assert torch.equal(ranks[0]["shm"]["pair_gather"], ranks[2]["shm"]["pair_gather"])


def test_quantized_all_reduce_sr_unbiased(world4):
    true = _x().sum(axis=0)
    res = world4[0]["allreduce"]
    single = np.abs(res["single"].numpy() - true).mean()
    mean = np.abs(res["mean"].numpy() - true).mean()
    assert mean < 0.5 * single, (mean, single)
    for r in world4[1:]:
        assert torch.equal(r["allreduce"]["mean"], res["mean"])


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_reduce_grads_bit_identical_across_layouts_and_reference(world4, mode):
    grads = {k: torch.from_numpy(v) for k, v in _grads_np().items()}
    none = reduce_grads(grads, None, None, CommsConfig(mode=mode), key=sr.PRNGKey(7))
    jout = j_reduce_grads({k: jnp.asarray(v) for k, v in _grads_np().items()}, None, None,
                          JCommsConfig(mode=mode), key=jax.random.PRNGKey(7))
    for r in world4:
        for shape in ((2, 2), (4, 1)):
            got = r[f"reduce_{mode}"][shape]
            for k in grads:
                assert torch.equal(got[k], none[k]), (shape, k)
    for k in grads:
        np.testing.assert_array_equal(_bits(none[k].numpy()), _bits(jout[k]), err_msg=k)


def test_commsconfig_parse_and_properties():
    cfg = CommsConfig.parse("INT4")
    assert cfg.mode == "int4" and cfg.bits == 4 and cfg.quantized
    assert cfg.compresses and cfg.cast_dtype is None
    q = cfg.quant_config()
    assert q.bits == 4 and q.signed and q.normalization == "blockwise"
    assert q.block_size == 128 and q.stochastic_rounding
    assert cfg.name == JCommsConfig.parse("INT4").name == "int4/B128/DE+SR"
    bf16 = CommsConfig(mode="bf16")
    assert not bf16.quantized and bf16.compresses
    assert bf16.cast_dtype == torch.bfloat16 and bf16.quant_config() is None
    fp32 = CommsConfig()
    assert not fp32.compresses and fp32.quant_config() is None
    assert GRAD_COMM_MODES == ("fp32", "bf16", "int8", "int4")
    assert GRAD_COMM_KEY_DOMAIN == 0x67726164
    with pytest.raises(ValueError, match="unknown grad-comm mode"):
        CommsConfig(mode="int2")


def test_commsconfig_validates_mapping():
    from repro_torch.core import mappings

    with pytest.raises(ValueError, match="registered mappings"):
        CommsConfig(mode="int4", mapping="ed")
    for name in mappings.registered():
        assert CommsConfig(mode="int4", mapping=name).quant_config().mapping == name


def test_grad_dtype_knob_is_gone():
    model = init_model(reduced_config("internlm2-1.8b"), device="cpu")
    with pytest.raises(TypeError):
        build_train_step(model, make_optimizer("adamw32", 1e-3), grad_dtype=torch.bfloat16)


def test_leaf_wire_bytes_matches_real_payload():
    cfg = CommsConfig(mode="int4")
    g = _grads()["embed"]
    fp32, wire = leaf_wire_bytes(tuple(g.shape), cfg)
    assert fp32 == g.numel() * 4
    assert wire == quantize(g, cfg.quant_config()).nbytes()
    assert leaf_wire_bytes((64,), cfg) == (256, 256)
    assert leaf_wire_bytes((64,), CommsConfig(mode="bf16")) == (256, 128)


def test_wire_report_ratios_and_floor():
    grads = _grads()
    reports = {r["mode"]: r for r in mode_totals(grads)}
    assert reports["fp32"]["ratio_vs_fp32"] == 1.0
    assert reports["bf16"]["ratio_vs_fp32"] == pytest.approx(2.0)
    assert reports["int8"]["ratio_vs_fp32"] > 3.5
    assert reports["int4"]["ratio_vs_fp32"] >= 4.0
    for mode in GRAD_COMM_MODES:
        j = j_wire_report(_jgrads(), JCommsConfig(mode=mode))
        t = reports[mode]
        for key in ("name", "n_leaves", "quantized_leaves", "total_fp32_bytes",
                    "total_wire_bytes", "ratio_vs_fp32"):
            assert t[key] == j[key], (mode, key)
        assert [(r["path"], r["wire_bytes"]) for r in t["leaves"]] == \
            [(r["path"], r["wire_bytes"]) for r in j["leaves"]]
    r = reports["int4"]
    assert r["quantized_leaves"] == 2 and r["n_leaves"] == 3
    assert sum(row["wire_bytes"] for row in r["leaves"]) == r["total_wire_bytes"]
    table = format_wire_table(mode_totals(grads), title="t")
    assert "int4" in table and "| grad-comm |" in table


def test_wire_report_gpt2m():
    cfg = ModelConfig(name="gpt2m-like", num_layers=24, d_model=1024, num_heads=16,
                      num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=50257,
                      blocks=(LayerSpec("dense", 0),) * 24, gated_mlp=False)
    r = wire_report(named_params(init_model(cfg, device="meta")), CommsConfig(mode="int4"))
    assert r["total_wire_bytes"] == 215_142_464 and r["total_fp32_bytes"] == 1_619_865_600
    assert r["ratio_vs_fp32"] >= 4.0


def test_reduce_grads_quantized_threshold_and_error():
    grads = _grads()
    key = grad_comm_key(sr.PRNGKey(0), 0)
    out = reduce_grads(grads, None, None, CommsConfig(mode="int4"), key=key)
    assert torch.equal(out["bias"], grads["bias"])  # sub-threshold: untouched, fp32
    for k in ("embed", "w"):
        g, d = grads[k], (out[k] - grads[k]).abs()
        assert float(d.max()) <= float(g.abs().max())
        assert float(d.mean()) < 0.2 * float(g.abs().mean())
        assert not torch.equal(out[k], g)


def test_reduce_grads_rtn_without_key_is_deterministic():
    cfg = CommsConfig(mode="int4")
    a = reduce_grads(_grads(), None, None, cfg, key=None)
    b = reduce_grads(_grads(), None, None, cfg, key=None)
    for k in a:
        assert torch.equal(a[k], b[k])
