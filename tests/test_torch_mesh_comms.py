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
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as JP  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from repro.comms import CommsConfig as JCommsConfig  # noqa: E402
from repro.comms import quantized_all_reduce as j_all_reduce  # noqa: E402
from repro.comms import reduce_grads as j_reduce_grads  # noqa: E402
from repro.core.quantizer import dequantize as j_dequantize  # noqa: E402
from repro.core.quantizer import quantize as j_quantize  # noqa: E402
from repro.kernels.sr import STREAM_GRAD, tensor_uniforms  # noqa: E402
from repro_torch.comms import CommsConfig, reduce_grads  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402

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
