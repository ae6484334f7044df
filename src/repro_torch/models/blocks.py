"""The block kinds: dense and MoE transformer blocks (attention + (gated)
MLP or a mixture of experts, pre-norm, with the reference's options: q/k
RMS norm, 2-D RoPE or M-RoPE, attention softcap, sandwich norms, gelu), the
xLSTM mLSTM and sLSTM blocks, hymba's block of attention and SSM heads in
parallel, and whisper's encoder and decoder blocks (LayerNorm, ungated
gelu MLP; the decoder's cross-attention over the encoder's output).

Port of ``repro/models/blocks.py`` (``LayerSpec``, ``apply_attention`` with
its three cache regimes, ``apply_mlp``, the block kinds and their decode
caches). A ``*Stack`` holds the parameters of ``L`` identical layers
stacked on a leading dim, in the reference's layout and under its names
(``attn/wq`` ``(L, D, H, dh)``, ``mlp/w1`` ``(L, D, F)``, ``moe/w1`` ``(L,
E, D, F)``, mLSTM ``wq`` ``(L, D, H, D//H)``, sLSTM ``r_gates`` ``(L, H, 4,
dh, dh)``, hymba ``ssm_B`` ``(L, D, H, ssm_state)``, ``norm1`` ``(L, D)``
or, under ``norm_type="layernorm"``, ``norm1/scale`` and ``norm1/bias``,
the decoder block's ``self/wq`` and ``cross/wq``, ...), so the optimizer
sees the reference's leaves; training and serving both walk the layers
through ``unstack``. Attention writes its K/V cache in place; the
recurrent kinds (``RECURRENT``: mLSTM, sLSTM, hymba's SSM heads) return
their new state beside ``x``, and the caller writes it back into its cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models import gla as gla_lib
from repro_torch.models.gla import GLAState, slstm_initial_state
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    dense,
    layernorm,
    mrope,
    rmsnorm,
    rope,
    rope_half,
)
from repro_torch.models.moe import moe_apply
from repro_torch.sharding import tensor_parallel as tp_lib

__all__ = ["LayerSpec", "DenseStack", "MoEStack", "MLSTMStack", "SLSTMStack", "HymbaStack",
           "EncStack", "DecStack", "STACKS", "RECURRENT", "unstack", "norm_params",
           "norm_apply", "apply_attention", "apply_mlp", "apply_dense", "apply_moe",
           "apply_mlstm", "apply_slstm", "apply_hymba", "apply_enc", "apply_dec", "slstm_ff",
           "init_block_cache"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "dense"  # dense | moe | mlstm | slstm | hymba | enc | dec
    window: int = 0  # 0 = full attention; >0 = sliding window


def _stacked(L, shape, device):
    return nn.Parameter(torch.empty((L,) + tuple(shape), dtype=torch.float32, device=device))


def norm_params(cfg, device, L: Optional[int] = None):
    """A norm's parameters, stacked over ``L`` layers (``None``: one norm):
    the RMS norm's scale, or LayerNorm's ``{scale, bias}``."""
    lead = () if L is None else (L,)
    make = lambda: nn.Parameter(torch.empty(lead + (cfg.d_model,), dtype=torch.float32,
                                            device=device))
    if cfg.norm_type == "layernorm":
        return nn.ParameterDict({"scale": make(), "bias": make()})
    return make()


def norm_apply(cfg, x: torch.Tensor, p) -> torch.Tensor:
    return layernorm(x, p) if cfg.norm_type == "layernorm" else rmsnorm(x, p)


def _attention_params(cfg, L: int, device, cross: bool = False) -> nn.ParameterDict:
    D, Hq, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {
        "wq": _stacked(L, (D, Hq, dh), device),
        "wk": _stacked(L, (D, Hkv, dh), device),
        "wv": _stacked(L, (D, Hkv, dh), device),
        "wo": _stacked(L, (Hq, dh, D), device),
    }
    if cfg.qk_norm and not cross:
        attn["q_norm"] = _stacked(L, (dh,), device)
        attn["k_norm"] = _stacked(L, (dh,), device)
    return nn.ParameterDict(attn)


class DenseStack(nn.Module):
    """Parameters of ``L`` dense layers, stacked (one scan unit)."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, Ff = cfg.d_model, cfg.d_ff
        self.attn = _attention_params(cfg, L, device)
        mlp = {"w1": _stacked(L, (D, Ff), device), "w2": _stacked(L, (Ff, D), device)}
        if cfg.gated_mlp:
            mlp["w3"] = _stacked(L, (D, Ff), device)
        self.mlp = nn.ParameterDict(mlp)
        self.norm1 = norm_params(cfg, device, L)
        self.norm2 = norm_params(cfg, device, L)
        if cfg.sandwich_norm:
            self.post1 = norm_params(cfg, device, L)
            self.post2 = norm_params(cfg, device, L)


class MoEStack(nn.Module):
    """Parameters of ``L`` MoE layers, stacked (one scan unit): attention,
    ``moe/router (L, D, E)``, ``moe/w1``, ``moe/w3 (L, E, D, F)``, ``moe/w2
    (L, E, F, D)``, ``norm1``, ``norm2``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, Ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.attn = _attention_params(cfg, L, device)
        self.moe = nn.ParameterDict({
            "router": _stacked(L, (D, E), device),
            "w1": _stacked(L, (E, D, Ff), device),
            "w3": _stacked(L, (E, D, Ff), device),
            "w2": _stacked(L, (E, Ff, D), device),
        })
        self.norm1 = norm_params(cfg, device, L)
        self.norm2 = norm_params(cfg, device, L)


class MLSTMStack(nn.Module):
    """Parameters of ``L`` mLSTM layers, stacked: ``w_in (L, D, 2D)``,
    ``wq``/``wk``/``wv`` ``(L, D, H, D//H)``, ``w_if (L, D, 2H)``, ``b_if (L,
    2H)``, ``w_out (L, D, D)``, ``norm (L, D)``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, H = cfg.d_model, cfg.num_heads
        self.w_in = _stacked(L, (D, 2 * D), device)
        self.wq = _stacked(L, (D, H, D // H), device)
        self.wk = _stacked(L, (D, H, D // H), device)
        self.wv = _stacked(L, (D, H, D // H), device)
        self.w_if = _stacked(L, (D, 2 * H), device)
        self.b_if = _stacked(L, (2 * H,), device)
        self.w_out = _stacked(L, (D, D), device)
        self.norm = norm_params(cfg, device, L)


def slstm_ff(d_model: int) -> int:
    """The sLSTM block's (always gated) MLP width: 4/3 of d_model, rounded
    (Python's ``round``) to a multiple of 128, at least 128."""
    return max(int(round(4 * d_model / 3 / 128)) * 128, 128)


class SLSTMStack(nn.Module):
    """Parameters of ``L`` sLSTM layers, stacked: ``w_gates (L, D, 4, D)``,
    ``r_gates (L, H, 4, dh, dh)``, ``w_out (L, D, D)``, ``mlp/w1``-``w3``
    (``slstm_ff`` wide), ``norm1``, ``norm2``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, H = cfg.d_model, cfg.num_heads
        dh, Ff = D // H, slstm_ff(D)
        self.w_gates = _stacked(L, (D, 4, D), device)
        self.r_gates = _stacked(L, (H, 4, dh, dh), device)
        self.w_out = _stacked(L, (D, D), device)
        self.mlp = nn.ParameterDict({"w1": _stacked(L, (D, Ff), device),
                                     "w2": _stacked(L, (Ff, D), device),
                                     "w3": _stacked(L, (D, Ff), device)})
        self.norm1 = norm_params(cfg, device, L)
        self.norm2 = norm_params(cfg, device, L)


class HymbaStack(nn.Module):
    """Parameters of ``L`` hymba layers, stacked: attention, the (gated) MLP,
    ``norm1``, ``norm2``, and the SSM heads: ``ssm_in (L, D, 2D)``, ``ssm_dt
    (L, D, H)``, ``ssm_dt_bias``, ``ssm_A_log``, ``ssm_D`` ``(L, H)``,
    ``ssm_B``, ``ssm_C`` ``(L, D, H, ssm_state)``, ``ssm_out (L, D, D)``,
    ``scale_attn``, ``scale_ssm`` ``(L, D)``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, H, Ff, st = cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.ssm_state
        self.attn = _attention_params(cfg, L, device)
        mlp = {"w1": _stacked(L, (D, Ff), device), "w2": _stacked(L, (Ff, D), device)}
        if cfg.gated_mlp:
            mlp["w3"] = _stacked(L, (D, Ff), device)
        self.mlp = nn.ParameterDict(mlp)
        self.norm1 = norm_params(cfg, device, L)
        self.norm2 = norm_params(cfg, device, L)
        self.ssm_in = _stacked(L, (D, 2 * D), device)
        self.ssm_dt = _stacked(L, (D, H), device)
        self.ssm_dt_bias = _stacked(L, (H,), device)
        self.ssm_B = _stacked(L, (D, H, st), device)
        self.ssm_C = _stacked(L, (D, H, st), device)
        self.ssm_A_log = _stacked(L, (H,), device)
        self.ssm_D = _stacked(L, (H,), device)
        self.ssm_out = _stacked(L, (D, D), device)
        self.scale_attn = _stacked(L, (D,), device)
        self.scale_ssm = _stacked(L, (D,), device)


def _ungated_mlp(cfg, L: int, device) -> nn.ParameterDict:
    D, Ff = cfg.d_model, cfg.d_ff
    return nn.ParameterDict({"w1": _stacked(L, (D, Ff), device), "w2": _stacked(L, (Ff, D), device)})


class EncStack(nn.Module):
    """Parameters of ``L`` whisper encoder layers, stacked: ``attn``, the
    ungated ``mlp`` (``w1 (L, D, F)``, ``w2 (L, F, D)``), ``norm1``,
    ``norm2``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        self.attn = _attention_params(cfg, L, device)
        self.mlp = _ungated_mlp(cfg, L, device)
        self.norm1 = norm_params(cfg, device, L)
        self.norm2 = norm_params(cfg, device, L)


class DecStack(nn.Module):
    """Parameters of ``L`` whisper decoder layers, stacked: ``self`` and
    ``cross`` attention (no q/k norms on ``cross``), the ungated ``mlp``,
    ``norm1``-``norm3``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        self.add_module("self", _attention_params(cfg, L, device))
        self.cross = _attention_params(cfg, L, device, cross=True)
        self.mlp = _ungated_mlp(cfg, L, device)
        self.norm1 = norm_params(cfg, device, L)
        self.norm2 = norm_params(cfg, device, L)
        self.norm3 = norm_params(cfg, device, L)


# the parameter stack of each block kind
STACKS = {"dense": DenseStack, "moe": MoEStack, "mlstm": MLSTMStack, "slstm": SLSTMStack,
          "hymba": HymbaStack, "enc": EncStack, "dec": DecStack}


def unstack(tree: Dict[str, Any], L: int) -> Iterator[Dict[str, Any]]:
    """Nested dict of stacked ``(L, ...)`` tensors -> one dict per layer, as
    views (one unbind per tensor, so backward stacks the grads once)."""

    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, l):
        if isinstance(node, dict):
            return {k: pick(v, l) for k, v in node.items()}
        return node[l]

    parts = split(tree)
    for l in range(L):
        yield pick(parts, l)


def _qk_normalize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm of q or k over head_dim (fp32, eps 1e-6)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope_apply(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_variant == "none":
        return x
    if cfg.rope_variant == "rope2d":
        return rope_half(x, positions, cfg.rope_theta)
    if cfg.rope_variant == "mrope":
        return mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return rope(x, positions, cfg.rope_theta)


def apply_attention(p, x: torch.Tensor, cfg, *, window: int = 0, causal: bool = True,
                    positions=None, kv_source: Optional[torch.Tensor] = None,
                    cache: Optional[attn_lib.KVCache] = None,
                    cur_pos: Optional[torch.Tensor] = None,
                    kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention, or cross-attention with ``kv_source``.

    Three cache regimes, as the reference's: ``cache`` + ``cur_pos`` with a
    one-token input is a decode step (circular write, position-masked
    attention); ``cache`` + ``kv_lengths`` with a whole sequence is a one-shot
    prefill (training attention, then the whole K/V sequence written into
    the cache at once); without a cache it is training attention. The cache
    is written in place. ``positions`` is (B, S), or (3, B, S) for M-RoPE,
    or None for no rotary. Cross-attention takes its queries from ``x`` and
    its K/V from ``kv_source`` (no rotary on them) and keeps no cache: every
    call, so every decode step, projects the whole source again, as the
    reference's decoder block does (its cross cache stays None).

    Under ``sharding.tensor_parallel.use``, a ``wq`` narrower than
    ``cfg.num_heads`` is this rank's heads ``[m·n, (m+1)·n)``: training
    attention runs on them with the rank's own kv slice (``wk``/``wv``
    shards) or, from whole kv weights, the kv heads its q heads read; the
    inputs enter the split (their gradients summed over the model group),
    as do the whole leaves used on the rank's heads only (``q_norm``,
    ``k_norm``, whole kv weights), and ``wo``'s partial product is summed
    over the group. A ``wq`` with fewer rows than ``cfg.d_model`` is this
    rank's rows (row-parallel, where the model axis does not divide the
    heads): q, and k/v from ``wk``/``wv`` cut alike, are the fp32 sums of
    the products of the rank's columns of the input (one
    ``tensor_parallel.own`` for the three, the source's own for
    cross-attention), rounded once; the attention runs whole on every rank
    on the sums; ``wo``, cut on its output dim, gives the rank's columns of
    the output from the entered attention output, joined over the group.
    """
    tp = tp_lib.current()
    split = tp is not None and p["wq"].shape[1] != cfg.num_heads
    rows = tp is not None and p["wq"].shape[0] != cfg.d_model
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = (p[k] if k in p else None for k in ("q_norm", "k_norm"))
    if (split or rows) and cache is not None:
        raise ValueError("tensor-parallel attention is the train step's: no cache")
    if split:
        x = tp_lib.enter(x, tp)
        kv_source = None if kv_source is None else tp_lib.enter(kv_source, tp)
        if wk.shape[1] == cfg.num_kv_heads:
            n = p["wq"].shape[1]
            idx = tp_lib.kv_heads(tp.index * n, n, cfg.num_heads, cfg.num_kv_heads)
            wk, wv = tp_lib.enter(wk, tp)[:, idx], tp_lib.enter(wv, tp)[:, idx]
        q_norm, k_norm = (None if t is None else tp_lib.enter(t, tp) for t in (q_norm, k_norm))
    src = x if kv_source is None else kv_source
    if rows:  # the rank's columns of the input: one join of each gradient
        tp_lib.CALLS["row_parallel_attention"] += 1
        part = tp_lib.own(x, tp)
        src_part = part if kv_source is None else tp_lib.own(kv_source, tp)
        q = _rows(x, p["wq"], "bsd,dhe->bshe", tp, cfg.d_model, part)
        k = _rows(src, wk, "bsd,dhe->bshe", tp, cfg.d_model, src_part)
        v = _rows(src, wv, "bsd,dhe->bshe", tp, cfg.d_model, src_part)
    else:
        q = dense(x, p["wq"], "bsd,dhe->bshe")
        k = dense(src, wk, "bsd,dhe->bshe")
        v = dense(src, wv, "bsd,dhe->bshe")
    if q_norm is not None:
        q = _qk_normalize(q, q_norm)
    if k_norm is not None:
        k = _qk_normalize(k, k_norm)
    if positions is not None:
        q = _rope_apply(cfg, q, positions)
        if kv_source is None:
            k = _rope_apply(cfg, k, positions)
    if cache is not None and cur_pos is not None and x.shape[1] == 1:
        attn_lib.cache_update(cache, k, v, cur_pos)
        out = attn_lib.decode_attention(q, cache, cur_pos, window=window,
                                        softcap_val=cfg.attn_softcap,
                                        k_chunk=cfg.decode_k_chunk)
    else:
        out = attn_lib.train_attention(q, k, v, causal=causal, window=window,
                                       softcap_val=cfg.attn_softcap,
                                       q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
        if cache is not None and kv_lengths is not None:
            attn_lib.cache_prefill(cache, k, v, kv_lengths)
    if split:
        return tp_lib.row_parallel(out, p["wo"], "bshe,hed->bsd", tp, COMPUTE_DTYPE)
    if rows:
        return _columns(out, p["wo"], cfg.d_model, "bshe,hed->bsd", tp, False)
    return torch.einsum("bshe,hed->bsd", out.to(COMPUTE_DTYPE), p["wo"].to(COMPUTE_DTYPE))


def apply_mlp(p, x: torch.Tensor, act: str = "silu", width: int = 0) -> torch.Tensor:
    """(Gated) MLP. ``gelu`` is the tanh form: ``jax.nn.gelu``'s default.
    ``width`` is the whole hidden width: under
    ``sharding.tensor_parallel.use`` a narrower ``w1`` is this rank's mlp
    columns, and ``w2``'s partial product is summed over the model group
    (the input enters the split)."""
    tp = tp_lib.current()
    split = tp is not None and 0 < width != p["w1"].shape[-1]
    if split:
        x = tp_lib.enter(x, tp)
    h = dense(x, p["w1"], "bsd,df->bsf")
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    if "w3" in p:
        a = a * dense(x, p["w3"], "bsd,df->bsf")
    if split:
        return tp_lib.row_parallel(a, p["w2"], "bsf,fd->bsd", tp, COMPUTE_DTYPE)
    return torch.einsum("bsf,fd->bsd", a, p["w2"].to(COMPUTE_DTYPE))


def apply_dense(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions,
                cache: Optional[attn_lib.KVCache] = None,
                cur_pos: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm dense block (the cache regimes of ``apply_attention``); with
    ``sandwich_norm`` each branch's output is normed again (``post1``,
    ``post2``) before the residual add."""
    h = apply_attention(p["attn"], norm_apply(cfg, x, p["norm1"]), cfg, window=spec.window,
                        positions=positions, cache=cache, cur_pos=cur_pos, kv_lengths=kv_lengths)
    if cfg.sandwich_norm:
        h = norm_apply(cfg, h, p["post1"])
    x = x + h
    h2 = apply_mlp(p["mlp"], norm_apply(cfg, x, p["norm2"]), cfg.act, cfg.d_ff)
    if cfg.sandwich_norm:
        h2 = norm_apply(cfg, h2, p["post2"])
    return x + h2


def apply_moe(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions,
              cache: Optional[attn_lib.KVCache] = None,
              cur_pos: Optional[torch.Tensor] = None,
              kv_lengths: Optional[torch.Tensor] = None):
    """Pre-norm MoE block (the reference's ``_apply_moe``): attention (the
    cache regimes of ``apply_attention``), then ``x + moe(norm2(x))``.
    Returns (x, the layer's fp32 load-balance aux loss)."""
    h = apply_attention(p["attn"], norm_apply(cfg, x, p["norm1"]), cfg, window=spec.window,
                        positions=positions, cache=cache, cur_pos=cur_pos, kv_lengths=kv_lengths)
    x = x + h
    out, aux = moe_apply(p["moe"], norm_apply(cfg, x, p["norm2"]), top_k=cfg.top_k,
                         group_size=cfg.moe_group_size, width=cfg.d_ff)
    return x + out, aux


def _divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype on its device: the reference divides
    a bf16 array by a weakly typed scalar, rounded to bf16 first; CUDA would
    multiply by the reciprocal of a host scalar."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _padded_identity(kv_lengths, S: int, log_a: torch.Tensor, k: torch.Tensor):
    """Right-padded prefill: a padded step becomes an exact identity of the
    recurrence (a = 1, k = 0), so S and n carry through it."""
    step_ok = torch.arange(S, device=k.device)[None, :] < kv_lengths[:, None]
    return (torch.where(step_ok[..., None], log_a, 0.0),
            torch.where(step_ok[..., None, None], k, 0.0))


def _split_of(p, whole: Dict[str, tuple], cache) -> Optional[tp_lib.TPRun]:
    """The model group where some of a recurrent block's leaves (``whole``:
    their whole shapes) are this rank's model shards, else None; a block
    computing on shards keeps no cache (the split is the train step's)."""
    tp = tp_lib.current()
    if tp is None or all(tuple(p[k].shape) == s for k, s in whole.items()):
        return None
    if cache is not None:
        raise ValueError("a tensor-parallel recurrent block is the train step's: no cache")
    return tp


def _columns(x: torch.Tensor, w: torch.Tensor, width: int, spec: str, tp, parts: bool):
    """``dense(x, w)`` whole on every rank. Where ``w`` holds this rank's
    columns of ``width`` only, its input enters the split and the products
    are joined over the model group: for consumers that compute on the
    rank's part (``parts``: its heads) the gradient is summed first."""
    if w.shape[-1] == width:
        return dense(x, w, spec)
    y = dense(tp_lib.enter(x, tp), w, spec)
    return tp_lib.gather_last(y, tp) if parts else tp_lib.collect(y, tp, -1)


def _rows(x: torch.Tensor, w: torch.Tensor, spec: str, tp, width: int,
          part: Optional[torch.Tensor] = None):
    """``dense(x, w)``, ``w``'s rows (its contracting dim) ``width`` whole.
    Where ``w`` holds this rank's rows only, the row-parallel product summed
    over the model group: of ``x`` where it is already the rank's part (its
    heads' columns), else of the rank's columns of the whole ``x``
    (``part``, or ``tensor_parallel.own(x)``)."""
    if w.shape[0] == width:
        return dense(x, w, spec)
    if x.shape[-1] == width:
        x = tp_lib.own(x, tp) if part is None else part
    return tp_lib.row_parallel(x, w, spec, tp, COMPUTE_DTYPE)


def apply_mlstm(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions=None,
                cache: Optional[GLAState] = None, cur_pos: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None):
    """The mLSTM block (the reference's ``_apply_mlstm``): up-projection to
    (xm, z), per-head q/k/v of ``D // H``, sigmoid input gate folded into k,
    ``log_sigmoid`` forget gate as the decay, the chunked recurrence (or one
    decode step), ``silu(z)`` gating and the down-projection. Returns (x,
    the new recurrent state).

    Under ``sharding.tensor_parallel.use``, with leaves that are this rank's
    model shards: ``w_in`` cut on its columns gives the rank's columns of
    (xm, z), joined over the model group. Where ``wq`` holds fewer heads
    than the config's, the rank runs the recurrence on its heads: its
    q/k/v heads, its columns of the gates (``w_if``, ``b_if`` cut on their
    2H dim) joined and its heads' i and f taken, its heads' z, and
    ``w_out``'s rows of its heads summed. Else the recurrence runs whole on
    every rank: q/k/v (and the gates, where ``w_if`` is cut on its rows)
    summed from the rank's rows, ``b_if`` added after the sum; ``w_if`` cut
    on its 2H dim gives the rank's gate columns, joined; ``w_out``'s
    product of the rank's columns summed."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    tp = _split_of(p, {"w_in": (D, 2 * D), "wq": (D, H, dh), "w_if": (D, 2 * H),
                       "w_out": (D, D)}, cache)
    n = p["wq"].shape[1]  # the heads this rank runs
    heads = n != H
    h = norm_apply(cfg, x, p["norm"])
    xm, z = _columns(h, p["w_in"], 2 * D, "bsd,de->bse", tp, heads).chunk(2, dim=-1)
    # the rank's columns of xm, for the products cut on their rows (one
    # join of its gradient however many read it; none where none does)
    part = tp_lib.own(xm, tp) if tp is not None and not heads else None
    q = _rows(xm, p["wq"], "bse,ehd->bshd", tp, D, part)
    k = _rows(xm, p["wk"], "bse,ehd->bshd", tp, D, part)
    k = k / _divisor(math.sqrt(dh), k)
    v = _rows(xm, p["wv"], "bse,ehd->bshd", tp, D, part)
    if p["w_if"].shape[-1] != 2 * H:  # the rank's gate columns, joined
        gates = dense(xm if heads else tp_lib.enter(xm, tp), p["w_if"],
                      "bse,eh->bsh").to(torch.float32) + p["b_if"]
        gates = tp_lib.gather_last(gates, tp) if heads else tp_lib.collect(gates, tp, -1)
    else:
        gates = _rows(xm, p["w_if"], "bse,eh->bsh", tp, D, part).to(torch.float32) + p["b_if"]
    i_gate, f_gate = gates.chunk(2, dim=-1)
    if heads:
        h0 = tp.index * n
        i_gate, f_gate = i_gate[..., h0:h0 + n], f_gate[..., h0:h0 + n]
        z = z[..., h0 * dh:(h0 + n) * dh]
    log_a = F.logsigmoid(f_gate)                 # (B, S, H)
    k = k * torch.sigmoid(i_gate)[..., None]     # fp32
    if kv_lengths is not None and S > 1:
        log_a, k = _padded_identity(kv_lengths, S, log_a, k)
    if cache is not None and S == 1:
        y, new = gla_lib.gla_decode_step(q, k, v, log_a, cache)
    else:
        y, new = gla_lib.gla_chunked(q, k, v, log_a, chunk=cfg.gla_chunk, init_state=cache)
    out = _rows(y.reshape(B, S, n * dh) * F.silu(z), p["w_out"], "bse,ed->bsd", tp, D)
    return x + out, new


def apply_slstm(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions=None,
                cache: Optional[gla_lib.SLSTMState] = None,
                cur_pos: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None):
    """The sLSTM block (the reference's ``_apply_slstm``): gate
    pre-activations ``W x``, the sequential cell (padded prefill steps
    frozen by ``step_mask``), the output projection, then a gated MLP.
    Returns (x, the new recurrent state).

    Under ``sharding.tensor_parallel.use``, with leaves that are this rank's
    model shards: ``w_gates`` cut on its last dim gives the rank's columns
    of every gate. Where ``r_gates`` holds fewer heads than the config's,
    those columns are the rank's heads: the cell runs on them and
    ``w_out``'s rows of its heads are summed. Else the columns are joined
    over the model group, the cell runs whole on every rank and
    ``w_out``'s product of the rank's columns is summed."""
    S, D = x.shape[1:]
    H = cfg.num_heads
    dh = D // H
    tp = _split_of(p, {"w_gates": (D, 4, D), "r_gates": (H, 4, dh, dh), "w_out": (D, D)}, cache)
    n = p["r_gates"].shape[0]  # the heads this rank runs
    h = norm_apply(cfg, x, p["norm1"])
    if n != H:  # the rank's columns are its heads'
        gates_x = dense(tp_lib.enter(h, tp), p["w_gates"], "bsd,dge->bsge")
    else:
        gates_x = _columns(h, p["w_gates"], D, "bsd,dge->bsge", tp, False)
    step_mask = None
    if kv_lengths is not None and S > 1:
        step_mask = torch.arange(S, device=x.device)[None, :] < kv_lengths[:, None]
    hs, new = gla_lib.slstm_scan(gates_x, p["r_gates"], n, init_state=cache,
                                 step_mask=step_mask)
    x = x + _rows(hs, p["w_out"], "bsd,de->bse", tp, D)
    return x + apply_mlp(p["mlp"], norm_apply(cfg, x, p["norm2"]), cfg.act,
                         slstm_ff(cfg.d_model)), new


def apply_hymba(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions,
                cache: Optional[Dict[str, Any]] = None, cur_pos: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None):
    """The hymba block (the reference's ``_apply_hymba``): attention and
    Mamba/SSD heads in parallel on one norm, their outputs rescaled and
    averaged, then the MLP. The SSM's decay is ``-softplus(dt) *
    exp(A_log)``, its heads ``D // H`` wide with ``ssm_state`` keys, no
    normalizer, a ``D`` skip. ``cache`` is ``{"attn": KVCache, "ssm":
    GLAState}``; the K/V cache is written in place. Returns (x, ``{"ssm":
    the new SSM state}``).

    Under ``sharding.tensor_parallel.use``, with SSM leaves that are this
    rank's model shards: ``ssm_in`` cut on its columns gives the rank's
    columns of (xm, z), joined over the model group. Where ``ssm_B`` holds
    fewer heads than the config's, the SSM runs on the rank's heads (its
    dt, A, D, B and C heads, its heads of xm and z) and ``ssm_out``'s rows
    of its heads are summed. Where ``ssm_B``/``ssm_C`` hold the rank's
    states, each rank's ``y`` over its states is an fp32 partial (``y`` is
    linear in the state dim), summed over the group, rounded once, and the
    ``D`` skip added after; dt, ``v`` and the decay are whole. Else the SSM
    runs whole. A product cut on its rows (``ssm_dt``, ``ssm_B``/``ssm_C``
    on ``embed``, ``ssm_out``) sums the products of the rank's columns."""
    B, S, D = x.shape
    H, st = cfg.num_heads, cfg.ssm_state
    tp = _split_of(p, {"ssm_in": (D, 2 * D), "ssm_dt": (D, H), "ssm_B": (D, H, st),
                       "ssm_out": (D, D)}, cache)
    n = p["ssm_B"].shape[1]  # the heads this rank runs
    heads, states = n != H, p["ssm_B"].shape[2] != st
    dh = D // H
    h = norm_apply(cfg, x, p["norm1"])
    kv, ssm = (None, None) if cache is None else (cache["attn"], cache["ssm"])
    a_out = apply_attention(p["attn"], h, cfg, window=spec.window, positions=positions,
                            cache=kv, cur_pos=cur_pos, kv_lengths=kv_lengths)
    xm, z = _columns(h, p["ssm_in"], 2 * D, "bsd,de->bse", tp, heads).chunk(2, dim=-1)
    # the rank's columns of xm, for the products cut on their rows (one
    # join of its gradient however many read it; none where none does)
    part = tp_lib.own(xm, tp) if tp is not None and not heads else None
    dt = F.softplus(_rows(xm, p["ssm_dt"], "bsd,dh->bsh", tp, D, part).to(torch.float32)
                    + p["ssm_dt_bias"])              # (B, S, H)
    log_a = -dt * torch.exp(p["ssm_A_log"])          # <= 0
    xs = tp_lib.enter(xm, tp) if states else xm      # the rank's states read all of xm
    k = _rows(xs, p["ssm_B"], "bsd,dhn->bshn", tp, D, part)
    q = _rows(xs, p["ssm_C"], "bsd,dhn->bshn", tp, D, part)
    xv = xm.reshape(B, S, H, dh)
    if heads:
        h0 = tp.index * n
        xv, z = xv[:, :, h0:h0 + n], z[..., h0 * dh:(h0 + n) * dh]
    v = xv * dt[..., None].to(COMPUTE_DTYPE)
    if kv_lengths is not None and S > 1:
        log_a, k = _padded_identity(kv_lengths, S, log_a, k)
    if ssm is not None and S == 1:
        y, new = gla_lib.gla_decode_step(q, k, v, log_a, ssm, normalize=False)
    elif states:  # the rank's states' fp32 partial of y, summed
        y, new = gla_lib.gla_chunked(q, k, tp_lib.enter(v, tp), tp_lib.enter(log_a, tp),
                                     chunk=cfg.gla_chunk, normalize=False,
                                     out_dtype=tp_lib.PARTIAL_DTYPE)
        y = tp_lib.leave(y, tp).to(v.dtype)
    else:
        y, new = gla_lib.gla_chunked(q, k, v, log_a, chunk=cfg.gla_chunk, normalize=False,
                                     init_state=ssm)
    y = y + p["ssm_D"][None, None, :, None].to(y.dtype) * v
    y = (y.reshape(B, S, n * dh) * F.silu(z)).to(COMPUTE_DTYPE)
    s_out = _rows(y, p["ssm_out"], "bse,ed->bsd", tp, D)
    x = x + 0.5 * (a_out * p["scale_attn"].to(COMPUTE_DTYPE)
                   + s_out * p["scale_ssm"].to(COMPUTE_DTYPE))
    x = x + apply_mlp(p["mlp"], norm_apply(cfg, x, p["norm2"]), cfg.act, cfg.d_ff)
    return x, {"ssm": new}


# the recurrent block kinds: apply(p, x, spec, cfg, ...) -> (x, new state)
RECURRENT = {"mlstm": apply_mlstm, "slstm": apply_slstm, "hymba": apply_hymba}


def apply_enc(p, x: torch.Tensor, spec: LayerSpec, cfg) -> torch.Tensor:
    """Whisper's encoder block (the reference's ``_apply_enc``): pre-norm
    bidirectional self-attention without rotary, then the ungated MLP with
    the tanh gelu (hard-wired, as in the reference)."""
    x = x + apply_attention(p["attn"], norm_apply(cfg, x, p["norm1"]), cfg, causal=False)
    return x + apply_mlp(p["mlp"], norm_apply(cfg, x, p["norm2"]), "gelu", cfg.d_ff)


def apply_dec(p, x: torch.Tensor, spec: LayerSpec, cfg, *, enc_out: torch.Tensor,
              cache: Optional[Dict[str, Any]] = None, cur_pos: Optional[torch.Tensor] = None,
              kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whisper's decoder block (the reference's ``_apply_dec``), each part
    pre-norm: causal self-attention without rotary (the cache regimes of
    ``apply_attention`` on ``cache["self"]``), cross-attention over
    ``enc_out`` (its K/V projected anew every call), then the ungated
    tanh-gelu MLP. ``cache`` is ``{"self": KVCache, "cross": None}``."""
    kv = None if cache is None else cache["self"]
    x = x + apply_attention(p["self"], norm_apply(cfg, x, p["norm1"]), cfg, window=spec.window,
                            cache=kv, cur_pos=cur_pos, kv_lengths=kv_lengths)
    x = x + apply_attention(p["cross"], norm_apply(cfg, x, p["norm2"]), cfg, causal=False,
                            kv_source=enc_out)
    return x + apply_mlp(p["mlp"], norm_apply(cfg, x, p["norm3"]), "gelu", cfg.d_ff)


def init_block_cache(cfg, spec: LayerSpec, batch: int, s_max: int, *, device, layers: int):
    """Decode-time cache of one block kind, stacked over ``layers``:

    * dense, moe: a ``KVCache``; windowed layers allocate only ``window``
      slots; the slot count is at least 256 and a multiple of 256, as in
      the reference;
    * mlstm: ``GLAState(S (L, B, H, dh, dh), n (L, B, H, dh))``, fp32 zeros;
    * slstm: ``SLSTMState(c, n, h (L, B, D)`` zeros, ``m`` -1e30);
    * hymba: ``{"attn": KVCache, "ssm": GLAState(S (L, B, H, ssm_state,
      dh), n (L, B, H, ssm_state))}``;
    * dec: ``{"self": KVCache, "cross": None}``: the cross-attention's K/V
      are not cached (recomputed from the encoder's output every step).
    """
    D, H = cfg.d_model, cfg.num_heads
    dh = D // H

    def kv():
        slots = min(s_max, spec.window) if spec.window > 0 else s_max
        slots = max(256, slots)
        if slots % 256:
            slots += 256 - slots % 256
        return attn_lib.make_cache(batch, slots, cfg.num_kv_heads, cfg.head_dim,
                                   device=device, layers=layers)

    def gla(dk, dv):
        z = lambda *s: torch.zeros((layers, batch, H) + s, dtype=torch.float32, device=device)
        return GLAState(z(dk, dv), z(dk))

    if spec.kind in ("dense", "moe"):
        return kv()
    if spec.kind == "mlstm":
        return gla(dh, dh)
    if spec.kind == "slstm":
        return slstm_initial_state(batch, D, device=device, lead=(layers,))
    if spec.kind == "hymba":
        return {"attn": kv(), "ssm": gla(cfg.ssm_state, dh)}
    if spec.kind == "dec":
        return {"self": kv(), "cross": None}
    raise ValueError(f"the port has no decode cache for {spec.kind!r} blocks")
