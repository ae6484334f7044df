"""Roofline counts of a cell by decomposition on the ``meta`` device (port of
``repro/roofline/measured.py``).

The reference compiles each scan unit's body and reads XLA's
``cost_analysis``. The port runs the decomposition eagerly on ``meta``
tensors, which hold shapes and no values:

    total = count(the model with one layer of each scan unit)
          + Σ_unit  count(one more layer of the unit) × (repeat - 1)
          + count(optimizer update)            (train only)

The model with one layer a unit carries everything counted once (the
embedding, the final norm, the loss or logits, the encoder output's norm,
the MoE aux loss's backward); a further layer is a probe.

* FLOPs are the matrix products' (``flops_counted: "matmul"``), by
  ``torch.utils.flop_counter``'s formulas, kept by the product's type
  (``flops_by_dtype``): the port's training attention multiplies in fp32,
  which the card runs off its tensor cores, so the compute term prices
  each type at its own rate (``analysis.HW.flops_rate``). Elementwise work
  is in the bytes.
* Bytes are a ``TorchDispatchMode``'s: each aten op's tensor operands and
  results off the CPU, views and metadata ops skipped. Eagerly, each op is a
  kernel that reads its operands from memory and writes its results, so
  this is what the eager port moves. The CUDA kernels of B1 are invisible
  to a dispatch mode: each of their passes (on the card, or standing in on
  ``meta``) adds its byte model (``b1_update_bytes``, ``b1_stats_bytes``).
* A probe is layers of a scan unit (``plan_scan_units``, built as a stack
  of their number, so its backward stacks their gradients as the real stack
  does), run through ``models.model._run_units`` at the rank's batch,
  forward and, for train cells, backward, less the layer loop's own work
  (its aux accumulator, which the model counts once). A further layer is a
  probe of one; for a unit that reads the encoder's output it is a probe of
  two less a probe of one, since that output's gradient is summed over the
  decoder's layers.
* The port's training attention is blockwise, as the reference's: only
  the (q-chunk, k-chunk) pairs left after pruning are formed (at S = 4096,
  causal, 20 of the 32 (512, 1024) pairs), padded to whole chunks, so the
  count holds the pairs the port runs and their padding. A windowed unit
  is counted whole, at its length. Only pure mLSTM/sLSTM units are
  extrapolated: a token-input decoder of such units only, at
  ``S`` beyond four GLA chunks (``S1``, a divisor of S), is counted from
  its tails at ``S`` (``_tail_cfg``) and probes of each unit at 2, 3 and 4
  chunks, extrapolated to ``n = S / S1`` chunks as a quadratic: the first
  chunk (no incoming state) differs, and the backward of each per-step or
  per-chunk slice writes a gradient of the whole length, so the eager
  port's bytes grow as ``n²``; from the second chunk on, each chunk's count
  is linear in its index, and the fit is exact.
* The recompute is counted where it runs: the probes and the model run
  the port's own recomputed regions (``models.remat``) under the counting
  modes, so a train layer under ``remat`` counts its forward twice (the
  forward, and again in the backward before its gradients), each
  attention pair's forward once more (the pair's own recompute), and each
  cross-entropy chunk's forward twice; the reference adds the same as a
  ``remat_fwd`` term. A train layer is still one probe.
* Decode: the tail (embedding, logits) and, per unit, one token through
  one layer with a single-layer cache (``blocks.init_block_cache(...,
  layers=1)``) times its repeat.
* Mesh: a train cell computes the rank's data shard (the global batch /
  the data size, ``batch_shardings``' rule) at its tensor-parallel share
  of the ``model`` axis (``compute_split: "data+model"`` where some leaf
  is split, ``sharding.tensor_parallel.placement``): the model and its
  probes run on the model shard of rank 0 of a model group (its heads or
  attention rows, mlp columns, experts or expert columns, recurrent heads,
  states or rows, and vocab rows or columns of the width; every other leaf
  whole), inside ``tensor_parallel.use``
  with the collectives ``without_world``, so the model group's sums and
  the expert outputs' gathers (the all-gathers' empty results, the adds in
  model rank order) are counted where they run. An MoE layer whose token groups span data
  shards computes as data rank 0 does: its tokens placed in their groups,
  the data group's gather of the routing's counts run without a world. A
  train cell on more than one rank walks the mesh step's own code with no
  world (``train.mesh.MeshStep.reckon``): its gathers, gradient exchange, the
  model group's sums, wire format, the optimizer's update on the rank's
  tiles and its collectives. The port serves on one device: on a mesh,
  serving ranks are data-parallel replicas with no collectives
  (``compute_split: "data"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.kernels import adamw4bit, sr
from repro_torch.launch.specs import decode_cache_len, input_specs
from repro_torch.models import ModelConfig, init_model, named_params, param_axes, plan_scan_units
from repro_torch.models.blocks import STACKS, init_block_cache
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.model import (
    ScanUnit,
    _run_units,
    _unit_layers,
    decode_step,
    params_loss,
    prefill,
)
from repro_torch.comms.collectives import Ranks, without_world
from repro_torch.models.axes import leaf_axes
from repro_torch.roofline.analysis import H100, HW, collective_bytes, model_flops, roofline_terms
from repro_torch.sharding import context
from repro_torch.sharding import tensor_parallel as tp_lib
from repro_torch.sharding.rules import dp_size, mesh_axis_sizes

__all__ = ["measure", "measure_cell", "Counter", "Tally", "b1_update_bytes", "b1_stats_bytes",
           "rank_batch", "LINEAR_KINDS", "MAX_LINEAR_PROBE"]

META = torch.device("meta")
LINEAR_KINDS = ("mlstm", "slstm")
MAX_LINEAR_PROBE = 4096  # the reference's longest probe of a linear unit
B1_PASSES = ("fused_adamw4", "rank1_new_stats")

aten = torch.ops.aten
# ops that move no tensor data (allocations, metadata, host reads)
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default, aten._unsafe_view.default,
    aten._local_scalar_dense.default, aten.lift_fresh.default, aten.set_.source_Storage,
    aten.resize_.default, aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
    aten.is_same_size.default, aten.record_stream.default,
}


def b1_update_bytes(L: int, R: int, C: int) -> float:
    """Least bytes of B1's update pass over ``(L, R, C)``: the fp32 param,
    grad, the two moments' 4-bit codes, m's B128 scales, v's rank-1 stats
    (old and new) and the SR seed rows read once; the param, codes and m
    scales written once."""
    n = L * R * C
    read = n * (4 + 4 + 0.5 + 0.5) + n / 128 * 4 + (2 * L * R + 2 * C) * 4 + L * 2 * 4
    write = n * (4 + 0.5 + 0.5) + n / 128 * 4
    return read + write


def b1_stats_bytes(L: int, R: int, C: int) -> float:
    """Least bytes of B1's stats pass: the fp32 grad and v's codes read
    once, the old stats read and the new ones written once."""
    return L * R * C * (4 + 0.5) + 2 * (L * R + C) * 4


_B1_BYTES = {"fused_adamw4": b1_update_bytes, "rank1_new_stats": b1_stats_bytes}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.numel() * x.element_size()
    return 0


class _Flops(TorchDispatchMode):
    """Matrix-product FLOPs by the result's type, by the formulas of
    ``torch.utils.flop_counter`` and with its dispatch (an op without a
    formula runs decomposed where it can be), so the total is
    ``FlopCounterMode``'s."""

    def __init__(self):
        super().__init__()
        self.by_dtype: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            if func is not torch.ops.prim.device.default:
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        dtype = next(t.dtype for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        name = str(dtype).removeprefix("torch.")
        self.by_dtype[name] = self.by_dtype.get(name, 0) + int(formula(*args, **kwargs,
                                                                       out_val=out))
        return out


class _Bytes(TorchDispatchMode):
    """Sums each aten op's operand and result bytes off the CPU. On ``meta``
    a boolean mask selects nothing (the count takes the values as finite:
    a NaN mask is empty on the card too)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.index.Tensor and args[0].device.type == "meta":
            idx = args[1]
            if len(idx) == 1 and idx[0] is not None and idx[0].dtype == torch.bool:
                out = args[0].new_empty((0,) + tuple(args[0].shape[idx[0].dim():]))
                self.bytes += _nbytes(args[0]) + _nbytes(idx[0])
                self.ops += 1
                return out
        out = func(*args, **kwargs)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in tree_leaves(out))
            self.ops += 1
        return out


@dataclasses.dataclass
class Tally:
    """What a stretch of work counts: matmul FLOPs by type, bytes (B1's
    byte models included), ops seen, B1's passes by name. Tallies add,
    subtract and scale by integers (the decomposition's arithmetic)."""

    flops_by_dtype: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    ops: int = 0
    b1: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(B1_PASSES, 0))

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def __add__(self, other: "Tally") -> "Tally":
        return self._combine(other, 1)

    def __sub__(self, other: "Tally") -> "Tally":
        return self._combine(other, -1)

    def __mul__(self, k: int) -> "Tally":
        return Tally({d: f * k for d, f in self.flops_by_dtype.items()}, self.bytes * k,
                     self.ops * k, {n: c * k for n, c in self.b1.items()})

    def _combine(self, other: "Tally", sign: int) -> "Tally":
        dts = list(self.flops_by_dtype) + [d for d in other.flops_by_dtype
                                           if d not in self.flops_by_dtype]
        flops = {d: self.flops_by_dtype.get(d, 0) + sign * other.flops_by_dtype.get(d, 0)
                 for d in dts}
        return Tally({d: f for d, f in flops.items() if f}, self.bytes + sign * other.bytes,
                     self.ops + sign * other.ops,
                     {n: self.b1[n] + sign * other.b1[n] for n in B1_PASSES})


class Counter(Tally):
    """A ``Tally`` of what runs inside it (``with Counter() as c``): the
    FLOPs of ``_Flops``, the bytes of ``_Bytes`` plus B1's byte models at
    each of its passes (``adamw4bit.LISTENERS``). Counters nest: each
    counts what runs inside it."""

    def __init__(self):
        super().__init__()

    def _heard(self, name: str, dims: Tuple[int, int, int]) -> None:
        self.b1[name] += 1
        self.bytes += _B1_BYTES[name](*dims)

    def __enter__(self):
        self._flop, self._bytes = _Flops(), _Bytes()
        adamw4bit.LISTENERS.append(self._heard)
        self._flop.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flop.__exit__(*exc)
        adamw4bit.LISTENERS.remove(self._heard)
        self.flops_by_dtype = {d: f for d, f in self._flop.by_dtype.items() if f}
        self.bytes += float(self._bytes.bytes)
        self.ops = self._bytes.ops
        return False


@dataclasses.dataclass
class CellMeasurement:
    total: Tally = dataclasses.field(default_factory=Tally)
    pieces: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def add(self, name: str, t: Tally, multiplier: int = 1, **extra) -> None:
        self.total = self.total + t * multiplier
        self.pieces.append({"name": name, "multiplier": multiplier, "flops": t.flops,
                            "flops_by_dtype": dict(t.flops_by_dtype), "bytes": t.bytes,
                            "ops": t.ops, "b1_passes": dict(t.b1), **extra})


def _unit_is_linear(unit: ScanUnit) -> bool:
    """Products linear in S: pure mLSTM/sLSTM units, the ones extrapolated
    (a windowed attention unit is counted whole, at its length)."""
    return all(spec.kind in LINEAR_KINDS for spec in unit.pattern)


def _linear_probe_len(cfg: ModelConfig, S: int) -> Optional[int]:
    """``S1``, one GLA chunk, where ``cfg`` is counted from probes at 2, 3
    and 4 of them (at most ``MAX_LINEAR_PROBE`` long) extrapolated to ``S``:
    a token-input decoder of linear units only, ``S`` a multiple of ``S1``
    beyond ``4·S1``. None where it is counted whole."""
    s1 = max(1, cfg.gla_chunk)
    if (cfg.family != "decoder" or cfg.input_mode != "tokens" or 4 * s1 > MAX_LINEAR_PROBE
            or S % s1 or S <= 4 * s1):
        return None
    return s1 if all(_unit_is_linear(u) for u in plan_scan_units(cfg.blocks)) else None


def rank_batch(B: int, n_dp: int) -> Tuple[int, int]:
    """(the rank's batch, the data shards): the batch dim is cut over the
    data axes where their size divides it (``batch_shardings``), else every
    rank computes the whole batch."""
    if n_dp > 1 and B % n_dp == 0:
        return B // n_dp, n_dp
    return B, 1


def _cut(batch: Mapping[str, torch.Tensor], Bl: int) -> Dict[str, torch.Tensor]:
    """The first ``Bl`` rows of every batch leaf (M-RoPE positions on dim 1)."""
    out = {}
    for k, v in batch.items():
        bdim = 1 if v.dim() >= 2 and v.shape[0] == 3 and v.shape[1] != 3 else 0
        out[k] = v.narrow(bdim, 0, Bl)
    return out


def _model_shard(params: Mapping[str, torch.Tensor], axes: Mapping[str, Tuple[str, ...]],
                 sizes: Optional[Mapping[str, int]]) -> Dict[str, torch.Tensor]:
    """``params`` as rank 0 of a model group computes on them: each leaf
    that ``tensor_parallel.placement`` splits on ``sizes``' model axis as
    its model shard (new ``meta`` leaves), every other one whole."""
    if sizes is None:
        return dict(params)
    split = tp_lib.placement({k: tuple(p.shape) for k, p in params.items()}, axes, sizes)
    out = {}
    for k, p in params.items():
        if split[k] is None:
            out[k] = p
            continue
        shape = list(p.shape)
        shape[split[k]] //= sizes["model"]
        out[k] = torch.empty(shape, dtype=p.dtype, device=META).requires_grad_(p.requires_grad)
    return out


def _probe_params(cfg: ModelConfig, unit: ScanUnit, root: str, dtype, train: bool,
                  layers: int = 1, sizes: Optional[Mapping[str, int]] = None):
    """``layers`` layers of ``unit``, as a stack of that many, under the
    model's paths (each leaf its model shard on ``sizes``' model axis, where
    given) -> the layer loop's (units, per-layer dicts)."""
    stacks = nn.ModuleDict({f"sub{si}": STACKS[spec.kind](cfg, layers, META)
                            for si, spec in enumerate(unit.pattern)})
    params, axes = {}, {}
    for k, p in stacks.named_parameters():
        t = p if dtype == torch.float32 else torch.empty(p.shape, dtype=dtype, device=META)
        path = f"{root}/0/" + k.replace(".", "/")
        sub, rel = k.split(".", 1)
        params[path] = t.requires_grad_(train)
        axes[path] = ("layers",) + leaf_axes(unit.pattern[int(sub[3:])].kind,
                                             rel.replace(".", "/"))
    params = _model_shard(params, axes, sizes)
    units = [ScanUnit(unit.pattern, layers)]
    return units, _unit_layers(params, units, root)


def _positions(cfg: ModelConfig, batch: Mapping[str, torch.Tensor], B: int, S: int, root: str):
    """What ``model._inputs`` gives the layer loop: (B, S) positions,
    M-RoPE's (3, B, S), or None (no rotary; the encoder)."""
    if root == "encoder" or cfg.rope_variant == "none":
        return None
    pos = torch.arange(S, device=META)[None].expand(B, S)
    if cfg.rope_variant == "mrope":
        given = batch.get("positions")
        return torch.stack([pos] * 3) if given is None else given
    return pos


def _loop_cost(cfg, x, positions) -> Counter:
    """The layer loop's own work (its aux accumulator), with no layer."""
    with Counter() as c, torch.no_grad():
        _run_units(cfg, [], [], x, positions)
    return c


def _seq_probe(cfg, unit, root, Bl, S, positions, train, dtype, layers=1,
               S_enc=0, sizes=None) -> Tally:
    """``layers`` layers of ``unit`` over (Bl, S) (at the model shard on
    ``sizes``, where given); a unit that reads the encoder's output reads
    (Bl, S_enc) of it. Every input is a new leaf, so no gradient is summed
    into one that an earlier probe left."""
    units, layers_ = _probe_params(cfg, unit, root, dtype, train, layers, sizes)
    x = torch.empty((Bl, S, cfg.d_model), dtype=COMPUTE_DTYPE, device=META, requires_grad=train)
    enc = (torch.empty((Bl, S_enc, cfg.d_model), dtype=COMPUTE_DTYPE, device=META,
                       requires_grad=train) if unit.pattern[0].kind == "dec" else None)
    pos = positions
    if pos is not None:  # the probe's length
        pos = pos[..., :S]
    with Counter() as c:
        if train:
            h, aux = _run_units(cfg, units, layers_, x, pos, enc_out=enc)
            outs, cots = [h], [torch.empty_like(h)]
            if aux.requires_grad:
                outs.append(aux)
                cots.append(torch.empty_like(aux))
            torch.autograd.backward(outs, cots)
        else:
            with torch.no_grad():
                _run_units(cfg, units, layers_, x, pos, enc_out=enc)
    return c - _loop_cost(cfg, x, pos)


def _decode_probe(cfg, unit, Bl, s_max, pos, enc) -> Tally:
    units, layers = _probe_params(cfg, unit, "decoder", COMPUTE_DTYPE, False)
    caches = [{f"sub{si}": init_block_cache(cfg, spec, Bl, s_max, device=META, layers=1)
               for si, spec in enumerate(unit.pattern)}]
    x = torch.empty((Bl, 1, cfg.d_model), dtype=COMPUTE_DTYPE, device=META)
    positions = None if cfg.rope_variant == "none" else pos[:, None]
    if cfg.rope_variant == "mrope":
        positions = torch.stack([positions] * 3)
    with Counter() as c, torch.no_grad():
        _run_units(cfg, units, layers, x, positions, caches=caches, cur_pos=pos, enc_out=enc)
    return c - _loop_cost(cfg, x, positions)


def _tail_cfg(cfg: ModelConfig) -> ModelConfig:
    """The model without its layers: what runs around the layer loop."""
    return dataclasses.replace(cfg, num_layers=0, blocks=(), encoder_blocks=())


def _one_layer_cfg(cfg: ModelConfig) -> ModelConfig:
    """The model with one layer of each scan unit, in the model's order."""
    one = lambda blocks: tuple(spec for u in plan_scan_units(blocks) for spec in u.pattern)
    dec = one(cfg.blocks)
    return dataclasses.replace(cfg, num_layers=len(dec), blocks=dec,
                               encoder_blocks=one(cfg.encoder_blocks))


def _model_count(cfg: ModelConfig, batch, train: bool, dtype, sizes=None) -> Counter:
    """The whole of ``cfg``'s train forward+backward or prefill (at the
    model shard on ``sizes``, where given)."""
    params = named_params(init_model(cfg, device="meta"))
    if dtype != torch.float32:
        params = {k: torch.empty(p.shape, dtype=dtype, device=META) for k, p in params.items()}
    params = _model_shard(params, param_axes(cfg) if sizes is not None else {}, sizes)
    with Counter() as c:
        if train:
            total, _ = params_loss(params, cfg, batch)
            total.backward()
        else:
            with torch.no_grad():
                prefill(params, cfg, batch)
    return c


def _extrapolate(y2: Tally, y3: Tally, y4: Tally, n: int) -> Tally:
    """The quadratic through the counts at 2, 3 and 4 chunks, at ``n``."""
    return y2 + (y3 - y2) * (n - 2) + (y4 - y3 * 2 + y2) * ((n - 2) * (n - 3) // 2)


def _optimizer(name: str):
    from repro_torch.core.optimizers import make_optimizer

    return make_optimizer(name, 1e-4)


def _one_device_update(opt, params, key, state) -> Counter:
    """The train step after the backward on one device: the update over
    the whole tree and the gradient norm, as ``build_train_step`` runs them."""
    grads = {k: torch.empty_like(p) for k, p in params.items()}
    with Counter() as c, torch.no_grad():
        opt.update(grads, state, params, key=sr.fold_in(key, 0))
        torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))
    return c


def _mesh_train(meas, cfg, sizes, opt, params, meta_state, accum_steps, comms,
                key, batch) -> Tuple[Dict[str, float], List[str]]:
    """A train cell on more than one rank: the mesh step's own code walked
    on rank 0's parts (every rank holds equal parts) with no world
    (``MeshStep.reckon``, the global ``batch`` giving the model group's
    sums their shapes): its exchange, and the optimizer's update on the
    rank's tiles with its moves. Returns the collectives record and the
    leaves updated on row tiles."""
    from repro_torch.sharding.specs import local_slice, map_plan
    from repro_torch.train.mesh import MeshStep

    run = context.MeshRun(sizes, rank=0)
    ms = MeshStep(run, cfg, {k: tuple(p.shape) for k, p in params.items()}, param_axes(cfg),
                  params, meta_state)
    # the rank's parts as new tensors, as shard_train_state cuts them
    cut = lambda t, spec: local_slice(t, spec, run.coord, sizes).clone()
    local = {k: cut(p, ms.param_plan[k]) for k, p in params.items()}
    state = map_plan(cut, meta_state, ms.state_plan)
    # each microbatch gathers and exchanges alike: walk one and two, and
    # extrapolate (exact: the step is affine in the microbatches)
    walks = []
    for n in sorted({1, min(2, accum_steps)}):
        update = Counter()
        with Counter() as c:
            result_bytes, calls = ms.reckon(local, state, opt, key, n, comms,
                                            around_update=update, batch=batch)
        walks.append((c - update, update, result_bytes, collective_bytes(calls)))
    (x1, update, b1, r1), (x2, _, b2, r2) = walks[0], walks[-1]
    extra = accum_steps - 1
    meas.add("mesh/exchange", x1 + (x2 - x1) * extra)
    meas.add("tail/optimizer_update", update)
    rec = {k: v + (r2[k] - v) * extra for k, v in r1.items()}
    moved = [k for k in ms.shapes if ms.work[k] != ms.boxes[k]]
    return dict(rec, result_bytes=b1 + (b2 - b1) * extra), moved


def measure(cfg: ModelConfig, shape: ShapeSpec, mesh=None, hw: HW = H100,
            optimizer: str = "adamw4bit", accum_steps: int = 1,
            comms=None) -> Dict[str, Any]:
    """The roofline record of ``cfg`` at ``shape`` on ``mesh`` (an ``{axis:
    size}`` mapping; None is one device) at one rank's share. Train cells
    run ``optimizer`` with stochastic rounding keyed (an optimizer without
    SR ignores the key) and ``accum_steps`` microbatches; ``comms`` is the
    gradient wire format (``comms.CommsConfig``; fp32 by default)."""
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {"data": 1, "model": 1}
    n_chips = 1
    for v in sizes.values():
        n_chips *= v
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    train = kind == "train"
    Bl, shards = rank_batch(B, dp_size(sizes))
    if not train:
        shards = 1  # serving replicas: each groups its own tokens
    if train and Bl % accum_steps:
        raise ValueError(f"a rank's batch of {Bl} does not split into {accum_steps} microbatches")
    Bm = Bl // accum_steps if train else Bl
    key = sr.PRNGKey(0)
    params = named_params(init_model(cfg, device="meta"))
    axes = param_axes(cfg)
    dtype = torch.float32 if train else COMPUTE_DTYPE
    batch = _cut(input_specs(cfg, shape), Bm) if kind != "decode" else None
    meas = CellMeasurement()
    D = cfg.d_model
    S_dec = S // 2 if cfg.family == "encdec" else S
    sections = [("decoder", cfg.blocks)]
    if cfg.family == "encdec" and kind != "decode":  # decode takes the encoder's output
        sections = [("encoder", cfg.encoder_blocks), ("decoder", cfg.blocks)]
    mult = accum_steps if train else 1
    what = "grad" if train else "fwd"
    # a train cell's compute at the tensor-parallel share of rank 0 of a
    # model group, its sums over the group run without a world
    split = tp_lib.placement({k: tuple(p.shape) for k, p in params.items()}, axes, sizes)
    tp_sizes = sizes if train and any(d is not None for d in split.values()) else None
    tp = (tp_lib.TPRun(Ranks(range(sizes["model"])), 0, sizes["model"], world=n_chips)
          if tp_sizes is not None else None)
    splitting = contextlib.ExitStack()
    if tp is not None:
        splitting.enter_context(tp_lib.use(tp))
        splitting.enter_context(without_world(n_chips))

    data_group = Ranks(range(shards))
    with context.batch_shards(shards, 0, data_group, world=n_chips), splitting:
        if kind == "decode":
            s_max = decode_cache_len(cfg, shape)
            pos = torch.empty((Bl,), dtype=torch.int32, device=META)
            for ui, unit in enumerate(plan_scan_units(cfg.blocks)):
                enc = (torch.empty((Bl, s_max, D), dtype=COMPUTE_DTYPE, device=META)
                       if unit.pattern[0].kind == "dec" else None)
                meas.add(f"decoder/unit{ui}/decode", _decode_probe(cfg, unit, Bl, s_max, pos, enc),
                         unit.repeat)
            tail_params = {k: torch.empty(p.shape, dtype=dtype, device=META)
                           for k, p in params.items() if not k.startswith(("decoder/", "encoder/"))}
            tok = torch.empty((Bl,), dtype=torch.int32, device=META)
            with Counter() as c, torch.no_grad():
                decode_step(tail_params, _tail_cfg(cfg), [], tok, pos)
            meas.add("tail/logits", c)
        elif (s1 := _linear_probe_len(cfg, S_dec)) is not None:
            n = S_dec // s1
            positions = _positions(cfg, batch, Bm, S_dec, "decoder")
            for ui, unit in enumerate(plan_scan_units(cfg.blocks)):
                ys = [_seq_probe(cfg, unit, "decoder", Bm, i * s1, positions, train, dtype,
                                 sizes=tp_sizes) for i in (2, 3, 4)]
                meas.add(f"decoder/unit{ui}/{what}", _extrapolate(*ys, n), unit.repeat * mult,
                         probe_len=[i * s1 for i in (2, 3, 4)],
                         probe_flops=[y.flops for y in ys], probe_bytes=[y.bytes for y in ys])
            meas.add("tail/embed_loss_grad" if train else "tail/logits",
                     _model_count(_tail_cfg(cfg), batch, train, dtype, tp_sizes), mult)
        else:
            meas.add("model/one_layer_a_unit",
                     _model_count(_one_layer_cfg(cfg), batch, train, dtype, tp_sizes), mult)
            for root, blocks in sections:
                for ui, unit in enumerate(plan_scan_units(blocks)):
                    if unit.repeat == 1:
                        continue
                    probe = lambda n: _seq_probe(cfg, unit, root, Bm, S_dec,
                                                 _positions(cfg, batch, Bm, S_dec, root), train,
                                                 dtype, n, S_dec, tp_sizes)
                    # a further layer; where the layers read the encoder's
                    # output, its gradient's sum over them is the difference
                    layer = probe(2) - probe(1) if unit.pattern[0].kind == "dec" else probe(1)
                    meas.add(f"{root}/unit{ui}/{what}", layer, (unit.repeat - 1) * mult)

    collectives, row_tiles = None, None
    if train:
        opt = _optimizer(optimizer)
        plain = {k: p.detach() for k, p in params.items()}
        with torch.no_grad():
            meta_state = opt.init(plain)
        if accum_steps > 1:  # autograd adds each microbatch's gradients, then the mean
            with Counter() as c, torch.no_grad():
                for p in plain.values():
                    g = torch.empty_like(p)
                    for _ in range(accum_steps - 1):
                        g = g + torch.empty_like(p)
                    g / accum_steps
            meas.add("tail/grad_accumulation", c)
        if n_chips > 1:
            collectives, row_tiles = _mesh_train(meas, cfg, sizes, opt, plain, meta_state,
                                                 accum_steps, comms, key,
                                                 input_specs(cfg, shape))
        else:
            meas.add("tail/optimizer_update", _one_device_update(opt, plain, key, meta_state))
    if collectives is None:
        collectives = dict(collective_bytes([]), result_bytes=0)

    total = meas.total
    tokens = B * (S if kind != "decode" else 1)
    mflops = model_flops(cfg, params, axes, kind, tokens)
    terms = roofline_terms({"flops": total.flops, "bytes accessed": total.bytes,
                            "flops by dtype": total.flops_by_dtype},
                           collectives["total"], n_chips, mflops, hw)
    out = {
        "arch": cfg.name,
        "shape": shape.name,
        "n_chips": n_chips,
        "mesh": dict(sizes),
        "method": "decomposed count on the meta device (one layer a unit whole, further "
                  "layers probed)",
        "compute_split": "data" if tp is None else "data+model",
        "flops_counted": "matmul",
        "flops_by_dtype": dict(total.flops_by_dtype),
        "rank_batch": Bl,
        "accum_steps": accum_steps if train else None,
        "optimizer": optimizer if train else None,
        "roofline": terms.as_dict(),
        "collectives": collectives,
        "pieces": meas.pieces,
    }
    if row_tiles is not None:  # the mesh step's update layout
        out["row_tile_leaves"] = row_tiles
    return out


def measure_cell(arch: str, shape_name: str, mesh, hw: HW = H100,
                 optimizer: str = "adamw4bit") -> Dict[str, Any]:
    """The reference's entry point: ``mesh`` is an ``{axis: size}``
    mapping (``launch.dryrun.MESHES``)."""
    return measure(get_config(arch), SHAPES[shape_name], mesh, hw, optimizer)
