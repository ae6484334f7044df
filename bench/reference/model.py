"""The decoder's loss and gradients in plain torch, from a configuration
file's sizes: pre-norm blocks of RMS norm, rotary GQA attention (causal,
softmax over all keys) and a SwiGLU MLP or a top-k mixture of experts,
then RMS norm, an untied head and the mean cross entropy over labels that
are not -1, plus the experts' load-balance loss times its coefficient.

Parameters follow the repository's stacked layout (``leaf_shapes``): layer
weights carry a leading layer dim under ``decoder/0/sub0/...``.

``rounding`` names the arithmetic (``ROUNDINGS``). ``bf16``, the
configuration's compute type, is the reference: every activation is stored
in bf16 (the embedded tokens, norm and rotary outputs, the attention's and
every product's outputs, the SwiGLU's and the residual sums, the experts'
combine weights and sum) and so is every gradient that flows into one, the
weight products take bf16 operands and accumulate in fp32, and the norms,
rotary, attention scores, softmax, loss and sums run in fp32 inside.
``fp8``, the control, keeps that and rounds every weight product's
operands to e4m3 and its incoming gradient to e5m2, each scaled per
tensor by its absmax, as fp8 training does. ``fp32`` rounds nothing. Layers are recomputed in the backward
(``torch.utils.checkpoint``), so the activations of one layer at a time
are held.

The mixture of experts routes each group of ``moe_group_size`` tokens (in
batch-major order): softmax of the router logits, the ``k`` largest (the
lower expert first on ties), renormalized; each expert takes at most
``C = max(4, int(T k f / E))`` assignments of a group, token-major, and
drops the rest. Its load-balance loss is ``E * mean_g sum_e(kept_e / T^2 *
mean_t prob_e)``, the kept counts carrying no gradient.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PREFIX = "decoder/0/sub0/"


def dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return dict(D=D, H=H, Hkv=cfg["num_key_value_heads"], dh=cfg.get("head_dim", D // H),
                F=cfg["intermediate_size"], V=cfg["vocab_size"], L=cfg["num_hidden_layers"],
                E=cfg.get("num_local_experts", 0), k=cfg.get("num_experts_per_tok", 0))


def leaf_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    d = dims(cfg)
    D, H, Hkv, dh, Ff, V, L, E = (d[k] for k in ("D", "H", "Hkv", "dh", "F", "V", "L", "E"))
    out = {"embed": (V, D), "head": (D, V), "final_norm": (D,),
           PREFIX + "attn/wq": (L, D, H, dh), PREFIX + "attn/wk": (L, D, Hkv, dh),
           PREFIX + "attn/wv": (L, D, Hkv, dh), PREFIX + "attn/wo": (L, H, dh, D),
           PREFIX + "norm1": (L, D), PREFIX + "norm2": (L, D)}
    if E:
        out.update({PREFIX + "moe/router": (L, D, E), PREFIX + "moe/w1": (L, E, D, Ff),
                    PREFIX + "moe/w3": (L, E, D, Ff), PREFIX + "moe/w2": (L, E, Ff, D)})
    else:
        out.update({PREFIX + "mlp/w1": (L, D, Ff), PREFIX + "mlp/w3": (L, D, Ff),
                    PREFIX + "mlp/w2": (L, Ff, D)})
    return out


_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _cast(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to bf16 or to an fp8 format scaled per tensor by its
    absmax, back in fp32."""
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    dtype, top = _FP8[kind]
    s = top / torch.amax(torch.abs(x)).clamp_min(1e-30)
    return (x * s).to(dtype).to(torch.float32) / s


class _Operand(torch.autograd.Function):
    """A product's operand rounded; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, kind):
        return _cast(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    """A product's output rounded; the gradient entering the product's
    backward rounded too, as the backward's products take it."""

    @staticmethod
    def forward(ctx, y, kind, grad_kind):
        ctx.grad_kind = grad_kind
        return _cast(y, kind)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, ctx.grad_kind), None, None


# (operands, output, incoming gradient) of every product
ROUNDINGS = {"fp32": None, "bf16": ("bf16", "bf16", "bf16"), "fp8": ("e4m3", "bf16", "e5m2")}
COMPUTE = {"bfloat16": "bf16", "float32": "fp32"}


def _act(t: torch.Tensor, rounding: str) -> torch.Tensor:
    """An activation as the configuration stores it: bf16 forward and in the
    backward (unless ``fp32``)."""
    return t if ROUNDINGS[rounding] is None else _Output.apply(t, "bf16", "bf16")


def _mm(a: torch.Tensor, b: torch.Tensor, spec: str, rounding: str) -> torch.Tensor:
    """``einsum(spec, a, b)`` accumulated in fp32 from operands rounded by
    ``rounding``, its output rounded, and in the backward the incoming
    gradient rounded (``ROUNDINGS``)."""
    kinds = ROUNDINGS[rounding]
    if kinds is None:
        return torch.einsum(spec, a, b)
    y = torch.einsum(spec, _Operand.apply(a, kinds[0]), _Operand.apply(b, kinds[0]))
    return _Output.apply(y, kinds[1], kinds[2])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh) rotated by position, the two halves paired."""
    S, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, rounding: str) -> torch.Tensor:
    d = dims(cfg)
    B, S, _ = x.shape
    q = _act(rope(_mm(x, p["wq"], "bsd,dhe->bshe", rounding), cfg["rope_theta"]), rounding)
    k = _act(rope(_mm(x, p["wk"], "bsd,dhe->bshe", rounding), cfg["rope_theta"]), rounding)
    v = _mm(x, p["wv"], "bsd,dhe->bshe", rounding)
    G = d["H"] // d["Hkv"]
    k = k.repeat_interleave(G, dim=2)  # q head h reads kv head h // G
    v = v.repeat_interleave(G, dim=2)
    # the scores, softmax and weighted sum in fp32 from the rounded q, k, v
    s = torch.einsum("bqhe,bkhe->bhqk", q, k) / math.sqrt(d["dh"])
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = torch.where(causal, s, float("-inf"))
    out = _act(torch.einsum("bhqk,bkhe->bqhe", torch.softmax(s, dim=-1), v), rounding)
    return _mm(out, p["wo"], "bshe,hed->bsd", rounding)


def _swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, spec,
            rounding: str) -> torch.Tensor:
    h = _act(F.silu(_mm(x, w1, spec[0], rounding)), rounding)
    return _mm(_act(h * _mm(x, w3, spec[0], rounding), rounding), w2, spec[1], rounding)


def mlp(p: dict, x: torch.Tensor, rounding: str) -> torch.Tensor:
    return _swiglu(x, p["w1"], p["w3"], p["w2"], ("bsd,df->bsf", "bsf,fd->bsd"), rounding)


def moe_capacity(T: int, k: int, E: int, factor: float) -> int:
    return min(max(4, int(T * k * factor / E)), T)


def moe(p: dict, x: torch.Tensor, cfg: dict, rounding: str):
    d = dims(cfg)
    E, k = d["E"], d["k"]
    B, S, D = x.shape
    N = B * S
    T = min(cfg["moe_group_size"], N)
    C = moe_capacity(T, k, E, cfg["moe_capacity_factor"])
    xf = x.reshape(N, D)
    probs = torch.softmax(_mm(xf, p["router"], "nd,de->ne", rounding), dim=-1)  # (N, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals = vals[:, :k] / torch.sum(vals[:, :k], dim=-1, keepdim=True)
    top_idx = idx[:, :k]
    with torch.no_grad():  # slots: token-major order inside each group
        onehot = F.one_hot(top_idx.reshape(N // T, T * k), E)
        slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1).reshape(N, k) - 1
        kept = slot < C
    out = torch.zeros_like(xf)
    for e in range(E):
        tok, j = torch.nonzero((top_idx == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(xf[tok], p["w1"][e], p["w3"][e], p["w2"][e], ("nd,df->nf", "nf,fd->nd"),
                    rounding)
        out = out.index_add(0, tok, y * _act(top_vals[tok, j], rounding)[:, None])
    with torch.no_grad():
        counts = F.one_hot(torch.where(kept, top_idx, E), E + 1)[..., :E].sum(1)  # (N, E)
        frac = counts.reshape(N // T, T, E).sum(1).to(torch.float32) / T
        frac = frac / T if ROUNDINGS[rounding] is None else _cast(_cast(frac, "bf16") / T,
                                                                    "bf16")
    mean_prob = probs.reshape(N // T, T, E).mean(1)
    aux = E * torch.mean(torch.sum(frac * mean_prob, dim=-1))
    return _act(out.reshape(B, S, D), rounding), aux


def block(x: torch.Tensor, p: dict, cfg: dict, rounding: str):
    eps = cfg["rms_norm_eps"]
    h = attention(p["attn"], _act(rmsnorm(x, p["norm1"], eps), rounding), cfg, rounding)
    x = _act(x + h, rounding)
    h = _act(rmsnorm(x, p["norm2"], eps), rounding)
    if "moe" in p:
        y, aux = moe(p["moe"], h, cfg, rounding)
    else:
        y, aux = mlp(p["mlp"], h, rounding), torch.zeros((), device=x.device)
    return _act(x + y, rounding), aux


def _layer(params: Dict[str, torch.Tensor], l: int) -> dict:
    tree: dict = {}
    for path, t in params.items():
        if path.startswith(PREFIX):
            *dirs, leaf = path[len(PREFIX):].split("/")
            node = tree
            for dd in dirs:
                node = node.setdefault(dd, {})
            node[leaf] = t[l]
    return tree


def loss(params: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
         labels: torch.Tensor, rounding: str = "fp32") -> torch.Tensor:
    """The training loss of one batch (tokens, labels (B, S))."""
    x = _act(params["embed"][tokens.long()], rounding)
    aux = torch.zeros((), device=x.device)
    for l in range(cfg["num_hidden_layers"]):
        x, a = checkpoint(block, x, _layer(params, l), cfg, rounding, use_reentrant=False)
        aux = aux + a
    h = _act(rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"]), rounding)
    logits = _mm(h, params["head"], "bsd,dv->bsv", rounding)
    lab = labels.long()
    mask = lab >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab.clamp_min(0)[..., None])[..., 0]
    ce = torch.sum((lse - gold) * mask) / mask.sum().clamp_min(1)
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux
