"""Model assembly for the reference's ten archs: decoders of dense, MoE,
mLSTM, sLSTM and hymba blocks, whisper's encoder-decoder and qwen2-vl's
embeds input with M-RoPE: config, scan units, init, forward, loss, and
serving (cacheless prefill, prefill with cache, decode step).

Port of ``repro/models/model.py`` (``ModelConfig``, ``plan_scan_units``,
``init_model``, ``forward_hidden``, ``loss_fn``, ``prefill``,
``init_serve_cache``, ``prefill_with_cache``, ``decode_step``). The layers
are grouped into the reference's scan units
(``plan_scan_units``: one periodic pattern, such as gemma2's local/global
pair, repeated, or maximal runs of equal layers); unit ``u`` holds one
stack of ``repeat`` layers per pattern position under the reference's paths
(``decoder/u/sub0/...``, ``decoder/u/sub1/...``), and a Python loop over
``r`` runs ``sub0[r], sub1[r], ...`` where the reference scans, summing
the MoE layers' load-balance losses in fp32 in that order (the loss adds
``0.01 *`` their sum). Tied embeddings have no ``head`` leaf: the head is
``embed.T``. An encoder-decoder (``family="encdec"``) runs its
``encoder`` units (non-causal, no rotary) over the frames plus sinusoidal
positions, then ``enc_norm``; the decoder's blocks cross-attend to that
output. ``input_mode="embeds"`` takes precomputed ``embeds`` in place of
tokens (the modality frontends are stubs, as in the reference).
``rope_variant`` is ``rope``, ``rope2d``, ``mrope`` (positions ``(3, B,
S)``, from ``batch["positions"]`` or three copies of ``arange(S)``) or
``none`` (bf16 sinusoidal positions added to the inputs). The decode caches
are per kind (``blocks.init_block_cache``): K/V caches, recurrent states,
both (hymba), or the decoder block's ``{"self": KVCache, "cross": None}``,
stacked over each stack's layers; layer ``r`` reads and writes views of
row ``r``. ``named_params`` gives the ordered ``{path: tensor}`` mapping
the optimizer takes; training and serving run the same forward over such a
mapping (serving over, for instance, ``serve.weights.materialize``'s
output), and the serving functions update the stacked decode caches in
place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from repro_torch import resolve_device
from repro_torch.models.blocks import (
    RECURRENT,
    STACKS,
    LayerSpec,
    apply_dec,
    apply_dense,
    apply_enc,
    apply_moe,
    init_block_cache,
    norm_apply,
    norm_params,
    unstack,
)
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    INIT_STD,
    chunked_cross_entropy,
    column_parallel_lookup,
    embed_lookup,
    row_parallel_cross_entropy,
    sinusoidal_at,
    sinusoidal_positions,
    softcap,
    vocab_parallel_cross_entropy,
    vocab_parallel_lookup,
)
from repro_torch.models.remat import recomputed
from repro_torch.sharding import tensor_parallel as tp_lib

__all__ = ["ModelConfig", "ScanUnit", "plan_scan_units", "Transformer", "init_model",
           "forward_hidden", "loss_fn", "named_params", "init_serve_cache", "decode_step",
           "prefill", "prefill_with_cache", "encode", "cache_map", "cache_leaves"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` field for field, less ``unroll_scans``:
    an XLA scan knob (the roofline's probes unroll its scans) with no eager
    counterpart, since the port's layer, attention-pair and loss-chunk
    loops are Python loops already. ``remat`` recomputes each repeat of a
    scan unit's pattern in the backward (``_run_units``), as the
    reference's ``jax.checkpoint`` of its scan body does; turn it off as the
    reference does, ``dataclasses.replace(cfg, remat=False)``.
    ``attn_q_chunk`` / ``attn_k_chunk`` size the training attention's
    (q, k) block pairs."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    blocks: Tuple[LayerSpec, ...]
    encoder_blocks: Tuple[LayerSpec, ...] = ()
    num_experts: int = 0
    top_k: int = 0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_variant: str = "rope"   # rope | rope2d | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    sandwich_norm: bool = False
    act: str = "silu"            # silu | gelu (tanh form)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    ssm_state: int = 16
    gla_chunk: int = 128
    moe_group_size: int = 2048
    input_mode: str = "tokens"   # tokens | embeds (modality-stub archs)
    family: str = "decoder"      # decoder | encdec
    remat: bool = True           # recompute each layer repeat in the backward
    attn_q_chunk: int = 512      # training attention's (q, k) block pairs
    attn_k_chunk: int = 1024
    decode_k_chunk: int = 1024
    ce_chunk: int = 512


@dataclasses.dataclass(frozen=True)
class ScanUnit:
    pattern: Tuple[LayerSpec, ...]
    repeat: int


def plan_scan_units(blocks: Tuple[LayerSpec, ...]) -> List[ScanUnit]:
    """Group layers into scan units (periodic pattern or maximal runs)."""
    L = len(blocks)
    for p in (1, 2, 3, 4):
        if L % p == 0 and L // p > 1:
            if all(blocks[i] == blocks[i % p] for i in range(L)):
                return [ScanUnit(tuple(blocks[:p]), L // p)]
    units: List[ScanUnit] = []
    i = 0
    while i < L:
        j = i
        while j < L and blocks[j] == blocks[i]:
            j += 1
        units.append(ScanUnit((blocks[i],), j - i))
        i = j
    return units


_OPTIONS = {"rope_variant": ("rope", "rope2d", "mrope", "none"),
            "norm_type": ("rmsnorm", "layernorm"), "act": ("silu", "gelu"),
            "input_mode": ("tokens", "embeds"), "family": ("decoder", "encdec")}


def _check_supported(cfg: ModelConfig) -> None:
    kinds = sorted({b.kind for b in cfg.blocks + cfg.encoder_blocks} - set(STACKS))
    if kinds:
        raise ValueError(f"{cfg.name}: unknown block kinds {kinds}; the port has {sorted(STACKS)}")
    if any(b.kind == "moe" for b in cfg.blocks) and not 0 < cfg.top_k <= cfg.num_experts:
        raise ValueError(f"{cfg.name}: moe blocks need 0 < top_k <= num_experts "
                         f"({cfg.top_k}, {cfg.num_experts})")
    for field, allowed in _OPTIONS.items():
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{cfg.name}: {field} {getattr(cfg, field)!r} is none of {allowed}")
    if len(cfg.blocks) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(cfg.blocks)} block specs for {cfg.num_layers} layers")


def _unit_stacks(cfg: ModelConfig, blocks: Tuple[LayerSpec, ...], device) -> nn.ModuleList:
    """One ``ModuleDict`` of ``sub{i}`` stacks per scan unit of ``blocks``."""
    return nn.ModuleList([
        nn.ModuleDict({f"sub{si}": STACKS[spec.kind](cfg, unit.repeat, device)
                       for si, spec in enumerate(unit.pattern)})
        for unit in plan_scan_units(blocks)])


class Transformer(nn.Module):
    """LM of the block kinds of ``STACKS``; parameters are fp32 masters in the reference's
    stacked layout, one ``ModuleDict`` of ``sub{i}`` stacks per scan unit of the
    ``decoder`` (and of the ``encoder``, with ``enc_norm``, for an encoder-decoder)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((V, D), dtype=torch.float32, device=device))
        self.decoder = _unit_stacks(cfg, cfg.blocks, device)
        if cfg.family == "encdec":
            self.encoder = _unit_stacks(cfg, cfg.encoder_blocks, device)
            self.enc_norm = norm_params(cfg, device)
        self.final_norm = norm_params(cfg, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty((D, V), dtype=torch.float32, device=device))

    def head_weight(self) -> torch.Tensor:
        """(D, V): ``head``, or ``embed.T`` with tied embeddings."""
        return self.embed.t() if self.cfg.tie_embeddings else self.head

    def forward(self, batch: Dict[str, torch.Tensor]):
        return loss_fn(self, batch)


def named_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``{path: parameter}`` with '/'-joined reference paths, in the
    reference's leaf order."""
    from repro_torch.core.optimizers.base import tree_order

    return tree_order({k.replace(".", "/"): p for k, p in model.named_parameters()})


# leaves the reference initialises to a constant, by path: a norm (``*norm*``,
# ``post1``/``post2``) is ones, or under LayerNorm ``{scale: ones, bias:
# zeros}``; mLSTM's ``b_if`` is 0 for the H input gates and 3.0 for the H
# forget gates
_CONSTANTS = {"ssm_dt_bias": -2.0, "ssm_A_log": 0.0, "ssm_D": 1.0, "scale_attn": 1.0,
              "scale_ssm": 1.0}


def _init_constant(path: str, p: torch.Tensor) -> bool:
    """Fill ``p`` if the reference makes its leaf a constant; True if so."""
    *dirs, leaf = path.split("/")
    norm = dirs[-1] if dirs and leaf in ("scale", "bias") else leaf
    if "norm" in norm or norm in ("post1", "post2"):
        p.fill_(0.0 if leaf == "bias" else 1.0)
    elif leaf in _CONSTANTS:
        p.fill_(_CONSTANTS[leaf])
    elif leaf == "b_if":
        H = p.shape[-1] // 2
        p[..., :H] = 0.0
        p[..., H:] = 3.0
    else:
        return False
    return True


@torch.no_grad()
def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               generator: Optional[torch.Generator] = None) -> Transformer:
    """Random model from a seed (or an explicit generator on ``device``):
    normal(0, 0.02) weights, the reference's constants elsewhere (unit norm
    scales, zero LayerNorm biases, mLSTM's gate bias, hymba's ``ssm_dt_bias``, ``ssm_A_log``,
    ``ssm_D`` and output scales). On the ``meta`` device only shapes are
    made. The draws are torch's, not ``jax.random``'s: to compute what the
    reference computes, load its parameters (``convert``)."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    model = Transformer(cfg, device=dev)
    if dev.type == "meta":
        return model
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    for path, p in named_params(model).items():
        if not _init_constant(path, p):
            p.normal_(0.0, INIT_STD, generator=generator)
    return model


# per unit, per sub: the list of that stack's per-layer parameter dicts
UnitLayers = List[List[Sequence[Dict[str, Any]]]]


def cache_map(fn, tree):
    """``fn`` applied to every tensor of a cache tree (lists, dicts,
    NamedTuples of tensors; ``None`` leaves, the decoder block's cross
    cache, stay ``None``), in a tree of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: cache_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cache_map(fn, v) for v in tree]
    return type(tree)(*(cache_map(fn, v) for v in tree))


def cache_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree, in order (``None`` leaves hold none)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    nodes = tree.values() if isinstance(tree, dict) else tree
    return [t for node in nodes for t in cache_leaves(node)]


def _write_back(view, new) -> None:
    """Copy a block's new recurrent state into its cache view, in place
    (hymba's: the SSM state of its ``{"attn", "ssm"}`` cache)."""
    if isinstance(view, dict):
        view = {k: view[k] for k in new}
    for a, b in zip(cache_leaves(view), cache_leaves(new)):
        a.copy_(b)


def _repeat(cfg: ModelConfig, unit: ScanUnit, stacks, r: int, x: torch.Tensor,
            aux: torch.Tensor, positions, caches: Optional[Dict[str, Any]],
            cur_pos: Optional[torch.Tensor], kv_lengths: Optional[torch.Tensor],
            enc_out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat ``r`` of ``unit``'s pattern, ``sub0[r], sub1[r], ...`` (the
    reference's scan body), each layer's parameters fetched here
    (``stacks[si][r]``) -> (x, aux plus its MoE layers' aux losses)."""
    for si, spec in enumerate(unit.pattern):
        c = None if caches is None else cache_map(lambda t: t[r], caches[f"sub{si}"])
        kw = dict(positions=positions, cache=c, cur_pos=cur_pos, kv_lengths=kv_lengths)
        p = stacks[si][r]
        if spec.kind == "moe":
            x, a = apply_moe(p, x, spec, cfg, **kw)
            aux = aux + a
        elif spec.kind == "dense":
            x = apply_dense(p, x, spec, cfg, **kw)
        elif spec.kind == "enc":
            x = apply_enc(p, x, spec, cfg)
        elif spec.kind == "dec":
            x = apply_dec(p, x, spec, cfg, enc_out=enc_out, cache=c, cur_pos=cur_pos,
                          kv_lengths=kv_lengths)
        else:
            x, state = RECURRENT[spec.kind](p, x, spec, cfg, **kw)
            if c is not None:
                _write_back(c, state)
    return x, aux


def _run_units(cfg: ModelConfig, units: List[ScanUnit], layers: UnitLayers, x: torch.Tensor,
               positions, caches: Optional[List[Dict[str, Any]]] = None,
               cur_pos: Optional[torch.Tensor] = None,
               kv_lengths: Optional[torch.Tensor] = None,
               enc_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop shared by training and serving, in the reference's
    order: per unit, ``sub0[r], sub1[r], ...`` for each repeat ``r``.
    ``caches[u]["sub{i}"]`` is that stack's ``(repeat, ...)`` cache: layer
    ``r`` reads and writes its views (K/V in place inside attention, a
    recurrent block's new state copied back here). Decoder blocks
    cross-attend to ``enc_out``. With ``cfg.remat`` and autograd on, each
    repeat is one recomputed region (``remat.recomputed``): the backward
    runs it again, fetching its layers' parameters again (a mesh step
    gathers them again), and saves only its input and the aux sum. Serving
    (``caches``, or no autograd) runs as it is; a cache under autograd with
    ``cfg.remat`` is refused. Returns (x, the fp32 sum of the MoE layers'
    aux losses in that order)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and caches is not None:
        if x.requires_grad:  # the serving input: embedded tokens
            raise ValueError(f"{cfg.name}: remat recomputes the training forward, which keeps "
                             "no cache: serve under torch.no_grad() or with remat=False")
        remat = False
    for ui, unit in enumerate(units):
        for r in range(unit.repeat):
            run = functools.partial(_repeat, cfg, unit, layers[ui], r)
            if remat:
                x, aux = recomputed(run, x, aux, positions, None, None, None, enc_out)
            else:
                x, aux = run(x, aux, positions, None if caches is None else caches[ui],
                             cur_pos, kv_lengths, enc_out)
    return x, aux


def forward_hidden(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inputs (tokens, or embeds; frames for an encoder-decoder) -> final
    hidden states (B, S, D) in bf16."""
    return _forward(named_params(model), model.cfg, batch)[0]


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]):
    """Causal LM loss (chunked CE, final-logit softcap) + 0.01 * the MoE
    load-balance aux. Returns (loss, metrics with ``ce_loss``, ``aux_loss``)."""
    return params_loss(named_params(model), model.cfg, batch)


def params_loss(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], unit_layers=None):
    """``loss_fn`` over a ``{path: tensor}`` mapping; ``unit_layers(units,
    root)`` gives the layer loop its per-layer parameters (by default
    ``_unit_layers`` over ``params``; the mesh step passes its gather
    hook). Under ``sharding.tensor_parallel.use``, an ``embed`` or head
    narrower than the vocabulary is this rank's vocab shard: the lookup and
    the cross entropy run vocab-parallel; one narrower than the model's
    width is this rank's share of it: the lookup runs column-parallel, the
    cross entropy row-parallel."""
    x, aux = _forward(params, cfg, batch, unit_layers)
    head, tp = _head(params, cfg), tp_lib.current()
    if tp is not None and head.shape[1] != cfg.vocab_size:  # this rank's vocab shard
        loss = vocab_parallel_cross_entropy(x, head, batch["labels"], tp,
                                            logit_cap=cfg.final_softcap, chunk=cfg.ce_chunk)
    elif tp is not None and head.shape[0] != cfg.d_model:  # this rank's rows of the head
        loss = row_parallel_cross_entropy(x, head, batch["labels"], tp,
                                          logit_cap=cfg.final_softcap, chunk=cfg.ce_chunk)
    else:
        loss = chunked_cross_entropy(x, head, batch["labels"], logit_cap=cfg.final_softcap,
                                     chunk=cfg.ce_chunk)
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss.detach(), "aux_loss": aux.detach()}


def _unit_layers(params: Mapping[str, torch.Tensor], units: List[ScanUnit],
                 root: str = "decoder") -> UnitLayers:
    """Per-unit, per-sub lists of per-layer parameter dicts of the ``root``
    stacks (``decoder`` or ``encoder``) from a ``{path: tensor}`` mapping."""
    out: UnitLayers = []
    for ui, unit in enumerate(units):
        subs = []
        for si in range(len(unit.pattern)):
            prefix = f"{root}/{ui}/sub{si}/"
            tree: Dict[str, Any] = {}
            for path, t in params.items():
                if path.startswith(prefix):
                    *dirs, leaf = path[len(prefix):].split("/")
                    node = tree
                    for d in dirs:
                        node = node.setdefault(d, {})
                    node[leaf] = t
            subs.append(list(unstack(tree, unit.repeat)))
        out.append(subs)
    return out


def _norm_of(params: Mapping[str, torch.Tensor], name: str):
    """The top-level norm ``name``: its scale, or LayerNorm's ``{scale, bias}``."""
    if name in params:
        return params[name]
    return {k: params[f"{name}/{k}"] for k in ("scale", "bias")}


def _head(params: Mapping[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """(D, V): ``head``, or ``embed.T`` with tied embeddings."""
    return params["embed"].t() if cfg.tie_embeddings else params["head"]


def _inputs(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]):
    """The decoder's input (B, S, D) in bf16 (embedded tokens, or the
    batch's ``embeds``) and its positions: (B, S), M-RoPE's (3, B, S)
    (``batch["positions"]``, else three copies of ``arange(S)``), or None
    for ``rope_variant="none"``, which adds the bf16 sinusoids to the input
    instead."""
    tp = tp_lib.current()
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(COMPUTE_DTYPE)
    elif tp is not None and params["embed"].shape[0] != cfg.vocab_size:  # its vocab shard
        x = vocab_parallel_lookup(params["embed"], batch["tokens"], tp)
    elif tp is not None and params["embed"].shape[1] != cfg.d_model:  # its columns
        x = column_parallel_lookup(params["embed"], batch["tokens"], tp)
    else:
        x = embed_lookup(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.rope_variant == "mrope":
        positions = batch.get("positions")
        return x, torch.stack([pos] * 3) if positions is None else positions
    if cfg.rope_variant == "none":
        return x + sinusoidal_positions(S, cfg.d_model, x.device)[None].to(x.dtype), None
    return x, pos


def encode(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
           frames: torch.Tensor, unit_layers=None) -> torch.Tensor:
    """An encoder-decoder's encoder: frames (B, Se, D) in bf16 plus the bf16
    sinusoids, the encoder units, ``enc_norm`` -> ``enc_out`` (B, Se, D)
    bf16, what ``decode_step`` cross-attends to."""
    e = frames.to(COMPUTE_DTYPE)
    e = e + sinusoidal_positions(e.shape[1], cfg.d_model, e.device)[None].to(e.dtype)
    units = plan_scan_units(cfg.encoder_blocks)
    layers = (unit_layers or (lambda u, root: _unit_layers(params, u, root)))(units, "encoder")
    e, _ = _run_units(cfg, units, layers, e, None)
    return norm_apply(cfg, e, _norm_of(params, "enc_norm"))


def _forward(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
             batch: Dict[str, torch.Tensor], unit_layers=None):
    """The reference's ``forward_hidden`` over a ``{path: tensor}`` mapping:
    (final hidden states (B, S, D) bf16, the fp32 MoE aux sum)."""
    x, positions = _inputs(params, cfg, batch)
    enc_out = (encode(params, cfg, batch["frames"], unit_layers) if cfg.family == "encdec"
               else None)
    units = plan_scan_units(cfg.blocks)
    layers = (unit_layers or (lambda u, root: _unit_layers(params, u, root)))(units, "decoder")
    x, aux = _run_units(cfg, units, layers, x, positions, enc_out=enc_out)
    return norm_apply(cfg, x, _norm_of(params, "final_norm")), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode over a parameter mapping
# ---------------------------------------------------------------------------


def _logits(params: Mapping[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, D) final hidden -> (B, V) fp32 logits (bf16 product; the head is
    ``embed.T`` when tied), final softcap applied."""
    logits = torch.einsum("bd,dv->bv", x.to(COMPUTE_DTYPE),
                          _head(params, cfg).to(COMPUTE_DTYPE)).to(torch.float32)
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def init_serve_cache(cfg: ModelConfig, batch: int, s_max: int,
                     device="cuda") -> List[Dict[str, Any]]:
    """Decode cache: per scan unit, ``{"sub{i}": cache}`` stacked over the
    unit's repeats: a ``KVCache`` (``(repeat, B, slots, Hkv, D)`` bf16,
    ``pos`` ``(repeat, B, slots)``; windowed subs hold ``min(s_max,
    window)`` slots), a recurrent state, or hymba's dict of both
    (``blocks.init_block_cache``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [{f"sub{si}": init_block_cache(cfg, spec, batch, s_max, device=dev,
                                          layers=unit.repeat)
             for si, spec in enumerate(unit.pattern)}
            for unit in plan_scan_units(cfg.blocks)]


def decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                caches: List[Dict[str, Any]], tokens: torch.Tensor, pos: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None):
    """One serving step: tokens (B,) at absolute positions pos (B,) ->
    (next-token logits (B, V) fp32, caches updated in place). An
    encoder-decoder's blocks cross-attend to ``enc_out`` (``encode``'s
    output). M-RoPE feeds ``pos`` to all three streams, as the reference
    does; ``rope_variant="none"`` adds the bf16 sinusoid of ``pos``."""
    units = plan_scan_units(cfg.blocks)
    x = embed_lookup(params["embed"], tokens[:, None])  # (B, 1, D)
    positions = pos[:, None]
    if cfg.rope_variant == "mrope":
        positions = torch.stack([positions] * 3)  # (3, B, 1)
    elif cfg.rope_variant == "none":
        x = x + sinusoidal_at(pos, cfg.d_model)[:, None].to(x.dtype)
        positions = None
    x, _ = _run_units(cfg, units, _unit_layers(params, units), x, positions,
                      caches=caches, cur_pos=pos, enc_out=enc_out)
    x = norm_apply(cfg, x, _norm_of(params, "final_norm"))
    return _logits(params, cfg, x[:, 0]), caches


def prefill(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cacheless prefill: the whole sequence forward once (the batch as
    ``loss_fn`` takes it, without labels) -> the logits at its last
    position (B, V) fp32."""
    x, _ = _forward(params, cfg, batch)
    return _logits(params, cfg, x[:, -1])


def prefill_with_cache(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       caches: List[Dict[str, Any]]):
    """One-shot prompt consumption (token-decoder archs only, as in the
    reference): right-padded tokens (B, S), real lengths
    (B,) -> (logits at each row's last real token (B, V) fp32, caches with
    the prompts' K/V and recurrent states written in place). Padded keys are
    never attended (causal), padded slots keep pos -1, and the recurrences
    take identity steps there (a = 1, k = 0; the sLSTM state frozen)."""
    if cfg.family != "decoder" or cfg.input_mode != "tokens":
        raise ValueError("prefill_with_cache serves token-decoder archs only")
    units = plan_scan_units(cfg.blocks)
    B = tokens.shape[0]
    x, positions = _inputs(params, cfg, {"tokens": tokens})
    x, _ = _run_units(cfg, units, _unit_layers(params, units), x, positions,
                      caches=caches, kv_lengths=lengths)
    x = norm_apply(cfg, x, _norm_of(params, "final_norm"))
    last = x[torch.arange(B, device=x.device), torch.clamp_min(lengths.long() - 1, 0)]
    return _logits(params, cfg, last), caches
