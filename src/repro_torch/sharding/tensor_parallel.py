"""Tensor-parallel compute on the ``model`` axis of the mesh step: the
counterpart of the reference's ``TP_RULES`` (``repro/sharding/rules.py``),
by which GSPMD partitions each product along its parameters' layouts, and of
``repro/sharding/context.py``'s per-layer constraint, which pins those
layouts inside the scan body.

The placement rule (``placement``), per leaf, from the cut that
``spec_for`` gives it on the ``model`` axis:

* attention is head-parallel where ``wq`` and ``wo`` are cut on ``heads``:
  the rank of model index ``m`` computes q heads ``[m·H/M, (m+1)·H/M)``;
  ``wk``/``wv`` are its own kv slice where they are cut on ``kv_heads``
  (``M`` divides ``Hkv``: the rank's q heads read exactly its kv heads),
  else they are gathered whole and the rank takes the kv heads its q heads
  read (``kv_heads``); ``q_norm``/``k_norm`` stay whole; ``wo``'s product
  is a partial summed over the model group;
* an MLP is mlp-parallel where ``w1`` (and ``w3``) and ``w2`` are cut on
  ``mlp``; ``w2``'s product is a partial summed over the model group;
* ``embed`` cut on ``vocab`` gives a vocab-parallel lookup (an id outside
  the rank's rows gives a zero row; the rows are summed) and, as ``head``
  cut on ``vocab`` does, or a tied head, vocab-parallel cross entropy
  (``models.layers``);
* every other leaf is gathered whole and computed the same on every rank
  of the model group (norms, MoE experts and router, the recurrent blocks'
  own leaves, an attention or MLP whose widths the axis does not divide).

A block knows it computes on a model shard by its leaves: inside ``use``,
a ``wq`` narrower than the config's heads, a ``w1`` narrower than the MLP's
width, an ``embed`` or head narrower than the vocabulary.

The two functions of the split: ``enter`` (identity forward, model-group
sum backward) at a column-parallel input, and ``leave`` (model-group sum
forward, identity backward) at a row-parallel output. A whole leaf that a
rank uses on its shard only (``q_norm``, gathered kv weights) enters too,
so its gradient is the whole group's. Every sum is an all-gather (recorded
in ``collectives.recording`` and ``STATS`` as one) followed by adds in
ascending model rank, so every rank of a group holds the same bits: the
replicated activations after a sum, on which every rank computes norms,
the residual stream and the loss, are bit-equal across the group. A
row-parallel partial is kept in fp32 (``PARTIAL_DTYPE``) and its sum
rounded to the compute type once, as the one-process product (fp32
accumulation, one rounding) is; a product of two bf16 values is exact in
fp32.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.comms.collectives import all_gather, timed, without_world
from repro_torch.sharding.rules import spec_for

__all__ = ["TPRun", "PARTIAL_DTYPE", "use", "current", "placement", "model_box", "enter",
           "leave", "group_max", "row_parallel", "kv_heads", "reckon_sums"]

# the type of a row-parallel partial and of its sum over the model group
PARTIAL_DTYPE = torch.float32

# the parent of a leaf, by the subtree that holds it
_ATTENTION = ("attn", "self", "cross")


@dataclasses.dataclass(frozen=True)
class TPRun:
    """A rank's model group: ``group`` (a process group, or a
    ``collectives.Ranks`` with no world), this rank's ``index`` in it and
    its ``size``; ``world`` is set where the collectives run
    ``without_world`` (the reckoning and the roofline on ``meta``)."""

    group: Any
    index: int
    size: int
    world: Optional[int] = None


_TP: contextvars.ContextVar[Optional[TPRun]] = contextvars.ContextVar("repro_tensor_parallel",
                                                                      default=None)


@contextlib.contextmanager
def use(tp: Optional[TPRun]) -> Iterator[None]:
    """Within it, blocks given model shards compute on them over ``tp``'s
    group (``None``: the one-device path)."""
    token = _TP.set(tp)
    try:
        yield
    finally:
        _TP.reset(token)


def current() -> Optional[TPRun]:
    return _TP.get()


def _model_dim(shape, axes, sizes) -> Optional[int]:
    spec = spec_for(tuple(shape), tuple(axes), sizes)
    dims = [d for d, e in enumerate(spec) if e == "model"]
    return dims[0] if dims else None


def placement(shapes: Mapping[str, Tuple[int, ...]], axes: Mapping[str, Tuple[str, ...]],
              sizes: Mapping[str, int]) -> Dict[str, Optional[int]]:
    """``{path: the dim the model axis cuts}`` for every leaf that computes
    tensor-parallel, ``None`` for every leaf gathered whole over the model
    axis (all of them where the axis is 1 or absent)."""
    out: Dict[str, Optional[int]] = dict.fromkeys(shapes)
    if int(sizes.get("model", 1)) <= 1:
        return out
    cut = {k: _model_dim(s, axes[k], sizes) for k, s in shapes.items()}

    def cuts(k: str, name: str) -> bool:
        return k in cut and cut[k] is not None and axes[k][cut[k]] == name

    parents = {k.rsplit("/", 1)[0] for k in shapes if "/" in k}
    for parent in parents:
        kind = parent.rsplit("/", 1)[-1]
        leaf = lambda n: f"{parent}/{n}"
        if kind in _ATTENTION and cuts(leaf("wq"), "heads") and cuts(leaf("wo"), "heads"):
            names = ["wq", "wo"] + [n for n in ("wk", "wv") if cuts(leaf(n), "kv_heads")]
        elif (kind == "mlp" and cuts(leaf("w1"), "mlp") and cuts(leaf("w2"), "mlp")
              and (leaf("w3") not in shapes or cuts(leaf("w3"), "mlp"))):
            names = [n for n in ("w1", "w2", "w3") if leaf(n) in shapes]
        else:
            continue
        for n in names:
            out[leaf(n)] = cut[leaf(n)]
    for k in ("embed", "head"):
        if cuts(k, "vocab"):
            out[k] = cut[k]
    return out


def model_box(shape: Sequence[int], dim: int, index: int, size: int
              ) -> Tuple[Tuple[int, int], ...]:
    """The model shard ``index`` of ``size`` of a whole leaf cut on ``dim``."""
    step = int(shape[dim]) // size
    return tuple((index * step, (index + 1) * step) if d == dim else (0, int(n))
                 for d, n in enumerate(shape))


def _sum(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """``x`` summed over the model group in ascending model rank."""
    with without_world(tp.world) if tp.world is not None else contextlib.nullcontext():
        every = timed(all_gather, x, tp.group)
    out = every[0].clone()
    for i in range(1, every.shape[0]):
        out.add_(every[i])
    return out


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.contiguous(), ctx.tp), None


class _Leave(torch.autograd.Function):
    """The model group's sum forward; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, tp):
        return _sum(x.contiguous(), tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """A replicated tensor as a column-parallel input: the same forward,
    its gradient summed over the model group."""
    return _Enter.apply(x, tp)


def leave(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """A rank's partial, summed over the model group (the gradient of the
    sum is each partial's)."""
    return _Leave.apply(x, tp)


def group_max(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """Elementwise max over the model group (no gradient)."""
    with without_world(tp.world) if tp.world is not None else contextlib.nullcontext():
        every = timed(all_gather, x.detach().contiguous(), tp.group)
    return torch.amax(every, dim=0)


def row_parallel(x: torch.Tensor, w: torch.Tensor, spec: str, tp: TPRun,
                 dtype: torch.dtype) -> torch.Tensor:
    """``einsum(spec, x, w)`` of a rank's shard of the contracting dim,
    summed over the model group: the operands rounded to ``dtype`` as the
    one-process product rounds them, the partial and its sum in
    ``PARTIAL_DTYPE``, the sum rounded to ``dtype`` once."""
    part = torch.einsum(spec, x.to(dtype).to(PARTIAL_DTYPE), w.to(dtype).to(PARTIAL_DTYPE))
    return leave(part, tp).to(dtype)


def kv_heads(start: int, n: int, heads: int, kv: int) -> Union[slice, List[int]]:
    """The kv heads that q heads ``[start, start + n)`` read (head ``h``
    reads ``h // (heads / kv)``): a slice where each of them serves an equal
    run of those q heads, else one kv head a q head."""
    group = heads // kv
    idx = [(start + i) // group for i in range(n)]
    lo, k = idx[0], len(set(idx))
    if n % k == 0 and idx == [lo + i // (n // k) for i in range(n)]:
        return slice(lo, lo + k)
    return idx


def reckon_sums(cfg, split: Mapping[str, Optional[int]], shapes: Mapping[str, Tuple[int, ...]],
                batch: Mapping[str, torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """One microbatch's model-group collectives, forward and backward, as
    empty ``meta`` tensors of what each gathers (``batch`` the rank's
    microbatch; ``split`` the ``placement``): per split attention, the
    partial of ``wo``, the input's gradient (and the encoder output's, for
    cross-attention) and the gradients of the whole leaves it uses on its
    heads; per split MLP, the partial of ``w2`` and the input's gradient;
    the vocab-parallel lookup's rows; the cross entropy's input gradient and
    per chunk the max, the sum of ``exp`` and the gold logit. A layer's
    partials (under ``cfg.remat``) and a chunk's merges (always) are summed
    twice: their regions run again in the backward."""
    from repro_torch.models.model import plan_scan_units

    B, S = batch["labels"].shape
    D = cfg.d_model
    forwards = 2 if cfg.remat else 1  # a layer's sums run again in its recompute
    act = lambda s, dt=dtype: torch.empty((B, s, D), dtype=dt, device="meta")
    Se = batch["frames"].shape[1] if cfg.family == "encdec" else 0
    out: List[torch.Tensor] = []
    if cfg.input_mode == "tokens" and split.get("embed") is not None:
        out.append(act(S))
    for root, blocks, s in (("encoder", cfg.encoder_blocks, Se), ("decoder", cfg.blocks, S)):
        for ui, unit in enumerate(plan_scan_units(blocks) if blocks else []):
            layer: List[torch.Tensor] = []
            for si in range(len(unit.pattern)):
                prefix = f"{root}/{ui}/sub{si}/"
                for sub in _ATTENTION:
                    wq = f"{prefix}{sub}/wq"
                    if split.get(wq) is None:
                        continue
                    layer += [act(s, PARTIAL_DTYPE)] * forwards + [act(s)]
                    if sub == "cross":
                        layer.append(act(Se))
                    for n in ("wk", "wv", "q_norm", "k_norm"):
                        k = f"{prefix}{sub}/{n}"
                        if k in shapes and split.get(k) is None:
                            layer.append(torch.empty(shapes[k][1:], dtype=torch.float32,
                                                     device="meta"))
                if split.get(f"{prefix}mlp/w1") is not None:
                    layer += [act(s, PARTIAL_DTYPE)] * forwards + [act(s)]
            out += layer * unit.repeat
    head = "embed" if cfg.tie_embeddings else "head"
    if split.get(head) is not None:
        out.append(act(S))
        chunk = min(cfg.ce_chunk, S)
        for s0 in range(0, S, chunk):
            c = min(chunk, S - s0)
            # the chunk's merges, in its forward and again in its recompute
            out += [torch.empty((B, c), dtype=torch.float32, device="meta")] * 6
    return out
