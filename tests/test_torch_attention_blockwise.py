"""The port's blockwise training attention against the reference's.

``repro_torch.models.attention.train_attention`` runs the reference's
online softmax over the (q-chunk, k-chunk) pairs that ``_block_pairs``
keeps. Each case feeds the same fp32 inputs, made from a seed with numpy,
to both (the reference's ``train_attention`` on the CPU, its gradients by
``jax.grad``, jitted once a case) with small chunks (16 queries, 32 keys), so
there are several pairs, and holds the output and the q/k/v gradients of
``sum(out * w)`` within 1e-5 of the largest magnitude of each. The cases:
causal and not, cross attention (``Sq != Sk``), GQA with G = 2, a window
that prunes pairs, a softcap, lengths that are not chunk multiples, and a
q chunk whose every pair is pruned (its rows are zeros). Beside: the pairs
are the reference's (20 of 32 at S = 4096), no pair's probabilities are
saved for the backward, and the serving path (no autograd) computes the
same output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import _block_pairs as j_block_pairs  # noqa: E402
from repro.models.attention import train_attention as j_train_attention  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

QC, KC = 16, 32
# name: (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap)
CASES = {
    "causal": (2, 64, 64, 4, 4, 8, True, 0, 0.0),
    "non_causal": (2, 64, 64, 4, 4, 8, False, 0, 0.0),
    "cross": (2, 40, 96, 4, 2, 8, False, 0, 0.0),
    "gqa2": (1, 64, 64, 4, 2, 16, True, 0, 0.0),
    "window_prunes": (1, 96, 96, 2, 1, 8, True, 20, 0.0),
    "softcap": (2, 64, 64, 4, 2, 8, True, 0, 5.0),
    "ragged": (2, 45, 45, 4, 2, 8, True, 0, 0.0),
    "ragged_cross": (1, 23, 77, 2, 1, 8, False, 0, 0.0),
    # 64 queries over 16 keys with a window of 8: the q chunks from 32 on
    # have no pair left
    "empty_q_chunk": (2, 64, 16, 2, 1, 8, True, 8, 0.0),
}
REL = 1e-5


def _inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D = CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    w = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    return q, k, v, w


def _flags(case):
    causal, window, cap = CASES[case][6:]
    return dict(causal=causal, window=window, softcap_val=cap, q_chunk=QC, k_chunk=KC)


def _close(got, want, what):
    bar = REL * max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= bar, (what, err, bar)


@pytest.mark.parametrize("case", list(CASES))
def test_output_and_gradients_match_reference(case):
    q, k, v, w = _inputs(case)
    kw = _flags(case)

    def j_loss(q_, k_, v_):
        out = j_train_attention(q_, k_, v_, **kw)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.train_attention(tq, tk, tv, **kw)
    torch.sum(out * torch.from_numpy(w)).backward()
    _close(out.detach().numpy(), np.asarray(j_out), "out")
    for name, t, g in zip("qkv", (tq, tk, tv), j_grads):
        _close(t.grad.numpy(), np.asarray(g), f"d{name}")
    if case == "empty_q_chunk":
        assert not out.detach()[:, 32:].any()


def test_pairs_are_the_reference_pruning():
    for nq, nk, qc, kc, causal, window in ((8, 4, 512, 1024, True, 0), (6, 3, 16, 32, True, 20),
                                           (4, 2, 16, 32, False, 0), (4, 1, 16, 16, True, 8),
                                           (3, 2, 512, 1024, False, 0)):
        assert A._block_pairs(nq, nk, qc, kc, causal, window) == j_block_pairs(
            nq, nk, qc, kc, causal, window)
    # internlm2-1.8b's train_4k layout: 20 of the 32 causal (512, 1024) pairs
    assert len(A._block_pairs(8, 4, 512, 1024, True, 0)) == 20


def test_no_pair_probabilities_are_saved():
    """Autograd keeps the carries and inputs, never a pair's (B, qc, Hkv, G,
    kc) scores or probabilities: every saved tensor is smaller than one."""
    q, k, v, _ = _inputs("causal")
    B, Sq, Sk, Hq, Hkv, D = CASES["causal"][:6]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = A.train_attention(tq, tk, tv, causal=True, q_chunk=QC, k_chunk=KC)
    scores = B * QC * Hq * KC
    assert saved and max(saved) < scores, (max(saved), scores)
    out.sum().backward()  # the recompute runs
    assert tq.grad is not None and torch.isfinite(tq.grad).all()


def test_serving_path_computes_the_same_output():
    q, k, v, _ = _inputs("softcap")
    kw = _flags("softcap")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with torch.no_grad():
        plain = A.train_attention(tq, tk, tv, **kw)
    graded = A.train_attention(tq.clone().requires_grad_(), tk, tv, **kw)
    assert torch.equal(plain, graded.detach())
