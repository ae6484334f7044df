"""Gated linear recurrences: the shared engine of the mLSTM (xLSTM) and the
Mamba/SSD heads of hymba, and the strictly sequential sLSTM cell.

Port of ``repro/models/gla.py``. The recurrence, per head, with a scalar
decay ``a_t`` in (0, 1]:

    S_t = a_t * S_{t-1} + k_t (x) v_t      (matrix state, dk x dv)
    n_t = a_t * n_{t-1} + k_t              (normalizer, mLSTM only)
    y_t = q_t . S_t  [ / max(|q_t . n_t|, 1) ]

``gla_chunked`` evaluates it a chunk at a time (a Python loop over the
chunks, the reference's ``unroll`` path): the intra-chunk terms as a masked
quadratic in the chunk, the inter-chunk ones through the carried state.
Everything inside runs in fp32; padding to a whole chunk uses ``log_a = 0``
(a = 1). The decay ratios are ``exp(cum_i - cum_j)`` computed first and
masked to ``j <= i`` after, in the reference's order (a ratio above the
diagonal can overflow; its gradient then is NaN in both packages).

``slstm_scan`` is the xLSTM sLSTM cell, a Python loop over time: stabilised
exponential gating (``m`` starts at -1e30), ``log_sigmoid`` forget gate, a
block-diagonal recurrent matrix per head; ``step_mask`` freezes all four
state tensors on padded steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["GLAState", "gla_chunked", "gla_decode_step", "SLSTMState", "slstm_scan"]


class GLAState(NamedTuple):
    S: torch.Tensor  # (B, H, dk, dv)
    n: torch.Tensor  # (B, H, dk)


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor, *,
                chunk: int = 128, normalize: bool = True,
                init_state: Optional[GLAState] = None,
                out_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, GLAState]:
    """q, k (B, S, H, dk), v (B, S, H, dv), log_a (B, S, H) <= 0 -> (y (B, S,
    H, dv) in ``out_dtype``, v's dtype by default, the final fp32 state)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))  # decay 0: a = 1
    N = q.shape[1] // c
    qs, ks, vs, las = (x.to(torch.float32).reshape(B, N, c, *x.shape[2:])
                       for x in (q, k, v, log_a))
    if init_state is None:
        S_prev = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
        n_prev = torch.zeros((B, H, dk), dtype=torch.float32, device=q.device)
    else:
        S_prev, n_prev = init_state.S.to(torch.float32), init_state.n.to(torch.float32)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))  # j <= i

    ys = []
    for i in range(N):
        qc, kc, vc, lac = qs[:, i], ks[:, i], vs[:, i], las[:, i]  # (B, c, H, *)
        cum = torch.cumsum(lac, dim=1)  # (B, c, H): log A_i
        last = cum[:, -1]               # (B, H)
        # inter-chunk: q_i . (A_i S_prev)
        y_inter = torch.einsum("bchk,bhkv->bchv", qc * torch.exp(cum)[..., None], S_prev)
        # intra-chunk: (q_i . k_j) exp(cum_i - cum_j), j <= i
        scores = torch.einsum("bchk,bdhk->bhcd", qc, kc)
        ratio = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B, c, c, H): i, j
        ratio = torch.where(tri[None, :, :, None], ratio, 0.0).permute(0, 3, 1, 2)  # (B,H,c,c)
        y = y_inter + torch.einsum("bhcd,bdhv->bchv", scores * ratio, vc)
        if normalize:
            n_i = torch.exp(cum)[..., None] * n_prev[:, None] + torch.einsum(
                "bhcd,bdhk->bchk", ratio, kc)
            denom = torch.abs(torch.einsum("bchk,bchk->bch", qc, n_i))
            y = y / torch.clamp_min(denom, 1.0)[..., None]
        ys.append(y)
        # carry
        k_end = kc * torch.exp(last[:, None] - cum)[..., None]  # k_j decayed to the chunk end
        decay = torch.exp(last)
        S_prev = decay[..., None, None] * S_prev + torch.einsum("bchk,bchv->bhkv", k_end, vc)
        n_prev = decay[..., None] * n_prev + torch.sum(k_end, dim=1)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(out_dtype or v.dtype), GLAState(S_prev, n_prev)


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor,
                    state: GLAState, *, normalize: bool = True) -> Tuple[torch.Tensor, GLAState]:
    """One recurrent step (serving): q, k (B, 1, H, dk), v (B, 1, H, dv),
    log_a (B, 1, H) -> (y (B, 1, H, dv) in v's dtype, the new fp32 state)."""
    a = torch.exp(log_a[:, 0].to(torch.float32))[..., None]  # (B, H, 1)
    q1, k1, v1 = (x[:, 0].to(torch.float32) for x in (q, k, v))
    S_new = a[..., None] * state.S + k1[..., None] * v1[..., None, :]
    n_new = a * state.n + k1
    y = torch.einsum("bhk,bhkv->bhv", q1, S_new)
    if normalize:
        denom = torch.abs(torch.einsum("bhk,bhk->bh", q1, n_new))
        y = y / torch.clamp_min(denom, 1.0)[..., None]
    return y[:, None].to(v.dtype), GLAState(S_new, n_new)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D): the exponential gates' stabilizer


def slstm_initial_state(batch: int, d: int, *, device, lead: Tuple[int, ...] = ()) -> SLSTMState:
    """Zeros for c, n and h, -1e30 for m (fp32), with optional leading dims."""
    shape = lead + (batch, d)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMState(z(), z(), z(), torch.full(shape, -1e30, dtype=torch.float32, device=device))


def slstm_scan(gates_x: torch.Tensor, r_weights: torch.Tensor, n_heads: int, *,
               init_state: Optional[SLSTMState] = None,
               step_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, SLSTMState]:
    """gates_x (B, S, 4, D): pre-activations of i, f, z, o from W x;
    r_weights (H, 4, dh, dh); step_mask (B, S) bool, False freezes the state
    -> (h (B, S, D) in gates_x's dtype, the final fp32 state)."""
    B, S, _, D = gates_x.shape
    dh = D // n_heads
    state = init_state or slstm_initial_state(B, D, device=gates_x.device)
    r = r_weights.to(torch.float32)
    hs = []
    for t in range(S):
        # recurrent contribution R h_{t-1}, block-diagonal per head
        rh = torch.einsum("hgij,bhj->bghi", r, state.h.reshape(B, n_heads, dh))
        pre = gates_x[:, t].to(torch.float32) + rh.reshape(B, 4, D)
        i_t, f_t, z_t, o_t = pre.unbind(1)
        # stabilised exponential gating (xLSTM eqs. 15-17)
        log_f = F.logsigmoid(f_t)
        m_new = torch.maximum(log_f + state.m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(log_f + state.m - m_new)
        c_new = f_p * state.c + i_p * torch.tanh(z_t)
        n_new = f_p * state.n + i_p
        h_new = torch.sigmoid(o_t) * (c_new / torch.clamp_min(torch.abs(n_new), 1.0))
        new = SLSTMState(c_new, n_new, h_new, m_new)
        if step_mask is not None:
            keep = step_mask[:, t, None]
            new = SLSTMState(*(torch.where(keep, a, b) for a, b in zip(new, state)))
        state = new
        hs.append(h_new)
    return torch.stack(hs, dim=1).to(gates_x.dtype), state
