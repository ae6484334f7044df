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
* attention is row-parallel where ``wq`` and ``wo`` are cut on ``embed``
  (the rules' last resort, where the axis does not divide the heads:
  hymba's 25, whisper's 20 on 8 or 16): q, and k/v where ``wk``/``wv`` are
  cut (on ``embed`` too), are summed from the products of the rank's
  columns of the input (``own``; one join of its gradient for the three,
  cross-attention's source its own); the attention runs whole on every
  rank on the sums; ``wo`` cut on its output dim is column-parallel, its
  input entered and the rank's ``D/M`` columns joined (``collect``);
* an MLP is mlp-parallel where ``w1`` (and ``w3``) and ``w2`` are cut on
  ``mlp``; ``w2``'s product is a partial summed over the model group;
* an MoE layer's experts are expert-parallel where ``w1``, ``w3`` and
  ``w2`` are cut on ``experts``: the rank of model index ``m`` runs experts
  ``[m·E/M, (m+1)·E/M)`` and the model group's expert outputs are gathered
  (``collect``); else each expert's FFN is mlp-parallel where the three
  are cut on ``mlp`` (``w2``'s partial summed), as mixtral's 8 experts on
  a 16-way axis fall through to; the router stays whole
  (``models.moe``);
* ``embed`` cut on ``vocab`` gives a vocab-parallel lookup (an id outside
  the rank's rows gives a zero row; the rows are summed) and, as ``head``
  cut on ``vocab`` does, or a tied head, vocab-parallel cross entropy
  (``models.layers``); cut on ``embed`` (a vocabulary the axis does not
  divide: hymba's 32,001, whisper's 51,866 on 4, 8 or 16), a
  column-parallel lookup (the rank's ``D/M`` columns of each row, joined)
  and, for ``head`` cut on ``embed`` or that tied head, row-parallel cross
  entropy (each chunk's logits summed from the products of the rank's
  columns of the input, the softcap and the log-sum-exp whole);
* a recurrent block's own leaves (mLSTM, sLSTM, hymba's SSM heads) compute
  on whatever cut the rules give each (``models.blocks``): a cut output dim
  is column-parallel (the products joined over the model group where more
  than the rank's columns follow), a cut contracting dim row-parallel
  (``own``: the rank's columns of the input; the partials summed); the
  recurrence runs on the rank's heads where ``wq``/``r_gates``/``ssm_B``
  are cut on ``heads``, on its states where ``ssm_B``/``ssm_C`` are cut on
  ``state`` (the fp32 partials of ``y`` summed), else whole on every rank;
* every other leaf is gathered whole and computed the same on every rank
  of the model group (an MLP or experts whose widths the axis does not
  divide). Of the leaves the rules cut on ``model``, three kinds stay
  whole by use: the norms and hymba's ``scale_attn``/``scale_ssm``, which
  scale the replicated stream on every rank; the MoE router, whose routing
  runs whole on every model rank; and the ``wk``/``wv`` of a head-parallel
  attention whose kv heads the axis does not divide (cut on ``embed`` by
  the rules), of which each rank reads the kv heads its q heads use. That
  last is a divergence from the reference's layout: gathering a layer's kv
  weights moves far fewer bytes than summing a ``(B, S, Hkv, dh)`` fp32
  partial over the group.

A block knows it computes on a model shard by its leaves: inside ``use``,
a ``wq`` narrower than the config's heads (head-parallel) or than its
width (row-parallel), a ``w1`` narrower than the MLP's width, an MoE ``w1``
with fewer experts than the router or narrower than the expert's width, an
``embed`` or head narrower than the vocabulary (vocab-parallel) or than
the model's width (column-parallel lookup, row-parallel cross entropy), a
recurrent leaf narrower than its whole shape. ``CALLS`` counts the calls
of the three ``embed``-cut modes.

The functions of the split: ``enter`` (identity forward, model-group sum
backward) at a column-parallel input, and ``leave`` (model-group sum
forward, identity backward) at a row-parallel output; ``collect`` joins the
ranks' shards of a product for a consumer that computes the whole on every
rank (the gradient: the rank's part), ``gather_last`` for consumers that
each compute on their rank's part (the gradient summed first), ``own``
takes the rank's columns of a replicated tensor for a row-parallel product
(the gradient: the group's parts joined). So each replicated tensor's
gradient is the whole one on every rank. A whole leaf that a rank uses on
its shard only (``q_norm``, gathered kv weights) enters too, so its
gradient is the whole group's. Every sum is an all-gather (recorded
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

from repro_torch.comms.collectives import timed_gather
from repro_torch.sharding.rules import spec_for

__all__ = ["TPRun", "PARTIAL_DTYPE", "CALLS", "use", "current", "placement", "model_box", "enter",
           "leave", "collect", "gather_last", "own", "group_max", "row_parallel", "kv_heads",
           "reckon_sums"]

# the type of a row-parallel partial and of its sum over the model group
PARTIAL_DTYPE = torch.float32

# calls of the ``embed``-cut modes (each recompute a call too)
CALLS = {"row_parallel_attention": 0, "column_parallel_lookup": 0,
         "row_parallel_cross_entropy": 0}

# the parent of a leaf, by the subtree that holds it
_ATTENTION = ("attn", "self", "cross")
# the recurrent blocks' own leaves (mLSTM, sLSTM, hymba's SSM heads): each
# computes on its model shard wherever the rules cut it; hymba's
# ``scale_attn``/``scale_ssm`` and the norms scale the replicated stream
_RECURRENT = ("w_in", "wq", "wk", "wv", "w_if", "b_if", "w_out", "w_gates", "r_gates",
              "ssm_in", "ssm_dt", "ssm_dt_bias", "ssm_B", "ssm_C", "ssm_A_log", "ssm_D",
              "ssm_out")


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
        elif kind in _ATTENTION and cuts(leaf("wq"), "embed") and cuts(leaf("wo"), "embed"):
            names = ["wq", "wo"] + [n for n in ("wk", "wv") if cut[leaf(n)] is not None]
        elif (kind == "mlp" and cuts(leaf("w1"), "mlp") and cuts(leaf("w2"), "mlp")
              and (leaf("w3") not in shapes or cuts(leaf("w3"), "mlp"))):
            names = [n for n in ("w1", "w2", "w3") if leaf(n) in shapes]
        elif kind == "moe" and any(all(cuts(leaf(n), axis) for n in ("w1", "w2", "w3"))
                                   for axis in ("experts", "mlp")):
            names = ["w1", "w2", "w3"]
        else:
            continue
        for n in names:
            out[leaf(n)] = cut[leaf(n)]
    for k in shapes:  # a recurrent block's leaf: directly under its sub
        parent, _, name = k.rpartition("/")
        if parent.rsplit("/", 1)[-1].startswith("sub") and name in _RECURRENT:
            out[k] = cut[k]
    for k in ("embed", "head"):  # on its vocabulary, or on its width
        if k in cut:
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
    every = timed_gather(x, tp.group, tp.world)
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


def _joined(x: torch.Tensor, tp: TPRun, dim: int) -> torch.Tensor:
    """The model group's equal shards of one tensor, joined on ``dim`` in
    model rank order."""
    return torch.cat(timed_gather(x.contiguous(), tp.group, tp.world).unbind(0), dim=dim)


class _Collect(torch.autograd.Function):
    """The model group's shards joined on ``dim`` forward; the gradient of
    the rank's own part backward (what follows is replicated)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim % x.dim(), x.shape[dim]
        return _joined(x, tp, ctx.dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.index * ctx.n, ctx.n), None, None


class _Own(torch.autograd.Function):
    """The rank's part of a replicated tensor's last dim forward; the
    group's parts of the gradient joined backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, n = tp, x.shape[-1] // tp.size
        return x.narrow(-1, tp.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _joined(grad, ctx.tp, -1), None


def enter(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """A replicated tensor as a column-parallel input: the same forward,
    its gradient summed over the model group."""
    return _Enter.apply(x, tp)


def leave(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """A rank's partial, summed over the model group (the gradient of the
    sum is each partial's)."""
    return _Leave.apply(x, tp)


def collect(x: torch.Tensor, tp: TPRun, dim: int = 0) -> torch.Tensor:
    """The ranks' shards of one tensor on ``dim``, joined in model rank
    order (the expert-parallel outputs on dim 0), for a consumer that
    computes the whole on every rank: each rank keeps its part's gradient."""
    return _Collect.apply(x, tp, dim)


def gather_last(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """The ranks' column shards of one tensor joined on its last dim, for
    consumers that each compute on their rank's part (its heads): the
    gradient summed over the model group, then the rank's columns kept."""
    return enter(collect(x, tp, -1), tp)


def own(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """The rank's equal part of a replicated tensor's last dim (the input
    of a product cut on its contracting dim); the gradient is the group's
    parts joined, so it is replicated as the tensor is."""
    return _Own.apply(x, tp)


def group_max(x: torch.Tensor, tp: TPRun) -> torch.Tensor:
    """Elementwise max over the model group (no gradient)."""
    return torch.amax(timed_gather(x.detach(), tp.group, tp.world), dim=0)


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


def _recurrent_sums(cfg, split: Mapping[str, Optional[int]], shapes, prefix: str, B: int,
                    S: int, dtype: torch.dtype, M: int
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The model group's collectives of one recurrent block's split compute
    (``models.blocks.apply_mlstm`` / ``apply_slstm`` / ``apply_hymba``
    below ``prefix``), as what each rank gathers: (the forward's, the
    backward's). Forward: a column-cut product joined (``collect``), each
    row-parallel partial and hymba's state partial of ``y`` summed.
    Backward: the sum of an entered input's gradient (the block's input at
    a column-cut product; the joined product where the rank computes on its
    heads; xm, ``v`` and the decay where it computes on its states; xm at
    mLSTM's gate columns where the cell runs whole) and the join of
    ``own``'s (the rank's columns of a whole tensor at a row-cut product)."""
    cut = lambda n: split.get(prefix + n)  # the stacked leaf's cut dim
    D, H = cfg.d_model, cfg.num_heads
    dh = D // H
    meta = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    part = lambda *shape: meta(*shape, dt=PARTIAL_DTYPE)
    fwd: List[torch.Tensor] = []
    bwd: List[torch.Tensor] = []

    def columns(name: str, width: int, heads: bool) -> None:
        if cut(name) is not None:  # joined; the input's gradient summed
            fwd.append(meta(B, S, width // M))
            bwd.append(meta(B, S, D))
            if heads:
                bwd.append(meta(B, S, width))

    def out(name: str, heads: bool) -> None:
        if cut(name) is not None:  # the partial summed (of own's columns)
            fwd.append(part(B, S, D))
            if not heads:
                bwd.append(meta(B, S, D // M))

    if prefix + "w_in" in shapes:  # mLSTM
        heads = cut("wq") == 2
        columns("w_in", 2 * D, heads)
        if not heads and (cut("wq") == 1 or cut("w_if") == 1):
            bwd.append(meta(B, S, D // M))  # own(xm)
        if cut("wq") == 1:
            fwd += [part(B, S, H, dh)] * 3
        if cut("w_if") == 2:  # the gate columns joined
            fwd.append(meta(B, S, 2 * H // M, dt=torch.float32))
            bwd.append(meta(B, S, 2 * H, dt=torch.float32) if heads else meta(B, S, D))
        elif cut("w_if") == 1:
            fwd.append(part(B, S, 2 * H))
        out("w_out", heads)
    elif prefix + "w_gates" in shapes:  # sLSTM
        heads = cut("r_gates") == 1
        if cut("w_gates") is not None:
            bwd.append(meta(B, S, D))
            if not heads:
                fwd.append(meta(B, S, 4, D // M))
        out("w_out", heads)
    elif prefix + "ssm_in" in shapes:  # hymba's SSM heads
        heads, states = cut("ssm_B") == 2, cut("ssm_B") == 3
        columns("ssm_in", 2 * D, heads)
        if not heads and (cut("ssm_dt") == 1 or cut("ssm_B") == 1):
            bwd.append(meta(B, S, D // M))  # own(xm)
        if cut("ssm_dt") == 1:
            fwd.append(part(B, S, H))
        if cut("ssm_B") == 1:
            fwd += [part(B, S, H, cfg.ssm_state)] * 2
        if states:
            fwd.append(part(B, S, H, dh))
            bwd += [meta(B, S, D), meta(B, S, H, dh), meta(B, S, H, dt=torch.float32)]
        out("ssm_out", heads)
    return fwd, bwd


def _row_attention_sums(cfg, split: Mapping[str, Optional[int]], prefix: str, B: int, S: int,
                        Skv: int, cross: bool, dtype: torch.dtype, M: int, forwards: int
                        ) -> List[torch.Tensor]:
    """The model group's collectives of one row-parallel attention
    (``models.blocks.apply_attention`` below ``prefix``), as what each rank
    gathers: forward (``forwards`` times), the fp32 partials of q, and of k
    and v (over ``Skv``) where ``wk``/``wv`` are cut, and ``wo``'s columns
    joined; backward, the joins of ``own``'s gradients (the input's, and the
    source's for cross-attention) and the sum at ``wo``'s entered input."""
    H, Hkv, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    meta = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    kv = [n for n in ("wk", "wv") if split.get(prefix + n) is not None]
    fwd = ([meta(B, S, H, dh, dt=PARTIAL_DTYPE)]
           + [meta(B, Skv, Hkv, dh, dt=PARTIAL_DTYPE)] * len(kv) + [meta(B, S, D // M)])
    bwd = [meta(B, S, D // M)] + ([meta(B, Skv, D // M)] if cross and kv else [])
    return fwd * forwards + bwd + [meta(B, S, H, dh)]


def reckon_sums(cfg, split: Mapping[str, Optional[int]], shapes: Mapping[str, Tuple[int, ...]],
                batch: Mapping[str, torch.Tensor], dtype: torch.dtype, model: int = 1,
                shards: Tuple[int, int] = (1, 0)) -> List[Tuple[torch.Tensor, str]]:
    """One microbatch's collectives of the split compute, forward and
    backward, as (an empty ``meta`` tensor of what each gathers, its group:
    ``"model"`` or ``"data"``) (``batch`` the rank's microbatch; ``split``
    the ``placement`` on a model axis of ``model``; ``shards`` the data
    shards and this rank's index): per head-parallel attention, the
    partial of ``wo``, the input's gradient (and the encoder output's, for
    cross-attention) and the gradients of the whole leaves it uses on its
    heads; per row-parallel attention, its partials, joins and sums
    (``_row_attention_sums``); per split MLP, the partial of ``w2`` and the input's gradient;
    per split recurrent block, its joins, partials and the backward's sums
    and joins (``_recurrent_sums``);
    per split MoE layer, the gathered expert outputs (or ``w2``'s partial)
    and the expert input's gradient; per MoE layer whose groups span data
    shards, the data group's gather of the routing's counts and
    probability sums; the vocab-parallel lookup's rows, or the
    column-parallel lookup's columns; the vocab-parallel cross entropy's
    input gradient and per chunk the max, the sum of ``exp`` and the gold
    logit, or the row-parallel cross entropy's join of ``own``'s gradient
    and per chunk the partial logits. A layer's forward collectives (under
    ``cfg.remat``) and a chunk's (always) run twice: their regions run
    again in the backward."""
    from repro_torch.models.model import plan_scan_units
    from repro_torch.models.moe import moe_shard_groups

    B, S = batch["labels"].shape
    D = cfg.d_model
    forwards = 2 if cfg.remat else 1  # a layer's sums run again in its recompute
    act = lambda s, dt=dtype: torch.empty((B, s, D), dtype=dt, device="meta")
    meta = lambda shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    Se = batch["frames"].shape[1] if cfg.family == "encdec" else 0
    out: List[Tuple[torch.Tensor, str]] = []
    on_model = lambda ts: [(t, "model") for t in ts]
    if cfg.input_mode == "tokens" and split.get("embed") == 0:  # the vocab rows summed
        out.append((act(S), "model"))
    elif cfg.input_mode == "tokens" and split.get("embed") == 1:  # the columns joined
        out.append((meta((B, S, D // model)), "model"))
    for root, blocks, s in (("encoder", cfg.encoder_blocks, Se), ("decoder", cfg.blocks, S)):
        for ui, unit in enumerate(plan_scan_units(blocks) if blocks else []):
            layer: List[Tuple[torch.Tensor, str]] = []
            for si in range(len(unit.pattern)):
                prefix = f"{root}/{ui}/sub{si}/"
                for sub in _ATTENTION:
                    wq = f"{prefix}{sub}/wq"
                    if split.get(wq) is None:
                        continue
                    if split[wq] == 1:  # (L, D, H, dh) cut on its rows: row-parallel
                        layer += on_model(_row_attention_sums(
                            cfg, split, f"{prefix}{sub}/", B, s, Se if sub == "cross" else s,
                            sub == "cross", dtype, model, forwards))
                        continue
                    layer += on_model([act(s, PARTIAL_DTYPE)] * forwards + [act(s)])
                    if sub == "cross":
                        layer.append((act(Se), "model"))
                    for n in ("wk", "wv", "q_norm", "k_norm"):
                        k = f"{prefix}{sub}/{n}"
                        if k in shapes and split.get(k) is None:
                            layer.append((meta(shapes[k][1:], torch.float32), "model"))
                if split.get(f"{prefix}mlp/w1") is not None:
                    layer += on_model([act(s, PARTIAL_DTYPE)] * forwards + [act(s)])
                fwd, bwd = _recurrent_sums(cfg, split, shapes, prefix, B, s, dtype, model)
                layer += on_model(fwd * forwards + bwd)
                router = f"{prefix}moe/router"
                if router in shapes:
                    E = shapes[router][-1]
                    span = moe_shard_groups(B * s, shards[0], shards[1], cfg.top_k, E,
                                            group_size=cfg.moe_group_size)
                    G, T, C = span.count, span.T, span.C
                    w1 = f"{prefix}moe/w1"
                    if split.get(w1) == 1:  # (L, E, D, F) cut on its experts
                        layer += on_model([meta((E // model, G, C, D))] * forwards)
                    elif split.get(w1) is not None:
                        layer += on_model([meta((E, G, C, D), PARTIAL_DTYPE)] * forwards)
                    if split.get(w1) is not None:
                        layer.append((meta((G, T, D)), "model"))
                    if span.split:
                        layer += [(meta((span.groups, 2, E), torch.float32), "data")] * forwards
            out += layer * unit.repeat
    head = "embed" if cfg.tie_embeddings else "head"
    if split.get(head) is not None:
        # the head's width is cut: embed (V, D) on dim 1, head (D, V) on dim 0
        rows = split[head] == (1 if cfg.tie_embeddings else 0)
        out.append((meta((B, S, D // model)) if rows else act(S), "model"))
        chunk = min(cfg.ce_chunk, S)
        for s0 in range(0, S, chunk):
            c = min(chunk, S - s0)
            # the chunk's partial logits, or its merges, in its forward and
            # again in its recompute
            if rows:
                out += on_model([meta((B, c, cfg.vocab_size), PARTIAL_DTYPE)] * 2)
            else:
                out += on_model([meta((B, c), torch.float32)] * 6)
    return out
