"""Continuous-batching serving engine.

Port of ``repro/serve/engine.py``. The engine owns ``max_batch`` cache slots
and drives them through admit -> prefill -> decode -> retire:

* **admit/prefill**: queued requests fill free slots, and their prompts go
  through ONE forward pass (``prefill_with_cache``), right-padded to a
  power-of-two bucket, into a fresh cache that is merged into the live one
  at the admitted slots only (every leaf of the cache tree: K/V, positions
  and recurrent states), so nothing of a slot's previous occupant
  survives. The first token of each stream is sampled from the prefill
  logits on the device.
* **decode**: chunks of ``drain_every`` decode steps stay on the device
  (sampling included); the host syncs once per chunk, on the (N, B) block
  of tokens.
* **retire**: at each drain the host walks the new tokens, ends streams on
  EOS or ``max_new_tokens`` (tokens decoded past the end inside the chunk
  are dropped), and frees their slots for the next tick's backfill.

The engine serves token decoders only, as the reference's: an
encoder-decoder or an embeds-input arch raises ``ValueError``. Weights are
held in the format ``weights=`` names (``serve.weights``); a
``q4`` tree stays packed on the device and ``materialize`` dequantizes it
once per prefill and once per decode chunk, never per token. The fp32
masters are not kept: after ``prepare_params`` only their shapes are (for
``weight_bytes``), so the caller may free them. Sampled streams depend on
(engine seed, request id) only, not on the slot (``serve.sampling``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.models import ModelConfig, decode_step, init_serve_cache, prefill_with_cache
from repro_torch.models.model import cache_leaves
from repro_torch.serve.sampling import request_key_words, sample_tokens
from repro_torch.serve.weights import materialize, prepare_params, weight_report

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = full vocab
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket_len(n: int, lo: int = 16) -> int:
    """Next power of two >= n (>= lo): the prefill width, so that distinct
    prompt lengths share a handful of shapes."""
    b = lo
    while b < n:
        b *= 2
    return b


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Mapping[str, torch.Tensor], max_batch: int = 4,
                 s_max: int = 256, weights: str = "bf16", drain_every: int = 8, seed: int = 0):
        if cfg.family != "decoder" or cfg.input_mode != "tokens":
            raise ValueError("ServeEngine serves token-decoder archs only")
        self.cfg = cfg
        self.max_batch = max_batch
        self.s_max = s_max
        self.weights_mode = weights
        self.drain_every = drain_every
        self.seed = seed
        self.device = next(iter(params.values())).device

        self.params = prepare_params(params, weights)
        self._master_shapes = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
        self.caches = init_serve_cache(cfg, max_batch, s_max, device=self.device)

        # Per-slot state; the host copies are the authority, sent to the
        # device at each dispatch.
        B = max_batch
        self.tokens = np.zeros((B,), np.int64)   # last sampled token
        self.pos = np.zeros((B,), np.int64)      # its absolute position
        self.kw = np.zeros((B, 2), np.int64)     # sampling key words
        self.gen_idx = np.zeros((B,), np.int64)  # tokens sampled so far
        self.temp = np.zeros((B,), np.float32)
        self.topk = np.zeros((B,), np.int64)

        self.active: List[Optional[Request]] = [None] * B
        self.queue: List[Request] = []
        # materialize calls, by phase (B3 runs once per QuantizedTensor each)
        self.materialize_calls: Dict[str, int] = {"prefill": 0, "decode": 0}
        # elapsed ms of each prefill and decode chunk on the card's clock
        # (CUDA events, idle gaps included; none on the CPU)
        self.phase_ms: Dict[str, List[float]] = {"prefill": [], "decode": []}

    @contextlib.contextmanager
    def _timed(self, phase: str):
        """CUDA events around a phase's device work; the wait on the end
        event stands in for the phase's own host sync that follows."""
        if self.device.type != "cuda":
            yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        end.synchronize()
        self.phase_ms[phase].append(start.elapsed_time(end))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _materialize(self, phase: str) -> Dict[str, Any]:
        self.materialize_calls[phase] += 1
        return materialize(self.params)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def weight_bytes(self) -> dict:
        """Exact weight-memory accounting of the serving format (structural,
        from the masters' shapes)."""
        return weight_report(self._master_shapes, self.weights_mode)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, toks, lens, admit) -> torch.Tensor:
        B = self.max_batch
        p = self._materialize("prefill")
        fresh = init_serve_cache(self.cfg, B, self.s_max, device=self.device)
        lengths = self._dev(lens)
        logits, fresh = prefill_with_cache(p, self.cfg, self._dev(toks), lengths, fresh)
        del p
        kw = self._dev(self.kw)
        first = sample_tokens(logits, kw, torch.zeros(B, dtype=torch.int64, device=self.device),
                              self._dev(self.temp), self._dev(self.topk))
        # merge the fresh cache at the admitted slots: every stacked leaf
        # (K/V, positions, recurrent states) along its batch axis, 1
        mask = self._dev(admit)
        for live, new in zip(cache_leaves(self.caches), cache_leaves(fresh)):
            live[:, mask] = new[:, mask]
        return first

    def _admit_and_prefill(self) -> List[int]:
        """Fill free slots from the queue; one batched prefill for them all."""
        admitted: List[int] = []
        for slot in range(self.max_batch):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                self.kw[slot] = request_key_words(self.seed, req.rid)
                self.temp[slot] = req.temperature
                self.topk[slot] = req.top_k
                admitted.append(slot)
        if not admitted:
            return admitted

        S = _bucket_len(max(len(self.active[s].prompt) for s in admitted))
        toks = np.zeros((self.max_batch, S), np.int64)
        lens = np.zeros((self.max_batch,), np.int64)
        admit = np.zeros((self.max_batch,), bool)
        for slot in admitted:
            p = self.active[slot].prompt
            toks[slot, : len(p)] = p
            lens[slot] = len(p)
            admit[slot] = True
        with self._timed("prefill"):
            first = self._prefill(toks, lens, admit)
        first = first.cpu().numpy()
        self.tokens = np.where(admit, first, self.tokens)
        self.pos = np.where(admit, lens, self.pos)
        self.gen_idx = np.where(admit, 1, self.gen_idx)
        for slot in admitted:
            self.active[slot].output.append(int(self.tokens[slot]))
            self._maybe_retire(slot)
        return admitted

    def _maybe_retire(self, slot: int) -> None:
        req = self.active[slot]
        hit_eos = req.eos_id is not None and req.output and req.output[-1] == req.eos_id
        if hit_eos or len(req.output) >= req.max_new_tokens:
            req.done = True
            self.active[slot] = None  # the slot backfills at the next tick

    @torch.no_grad()
    def _decode_chunk(self) -> torch.Tensor:
        p = self._materialize("decode")
        tok, pos, gen = self._dev(self.tokens), self._dev(self.pos), self._dev(self.gen_idx)
        kw, temp, topk = self._dev(self.kw), self._dev(self.temp), self._dev(self.topk)
        out = []
        for _ in range(self.drain_every):
            logits, self.caches = decode_step(p, self.cfg, self.caches, tok, pos)
            tok = sample_tokens(logits, kw, gen, temp, topk)
            out.append(tok)
            pos = pos + 1
            gen = gen + 1
        return torch.stack(out)

    def _decode(self) -> np.ndarray:
        """``drain_every`` decode steps on the device; one host sync."""
        with self._timed("decode"):
            toks = self._decode_chunk()
        toks = toks.cpu().numpy()  # (N, B): the one sync
        n = toks.shape[0]
        self.tokens = toks[-1].copy()
        self.pos = self.pos + n
        self.gen_idx = self.gen_idx + n
        return toks

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit+prefill, then decode ``drain_every`` tokens on the
        device and drain them. Returns False when idle."""
        self._admit_and_prefill()
        if all(r is None for r in self.active):
            return False
        toks = self._decode()
        for slot in range(self.max_batch):
            req = self.active[slot]
            if req is None:
                continue
            for n in range(toks.shape[0]):
                req.output.append(int(toks[n, slot]))
                self._maybe_retire(slot)
                if self.active[slot] is None:
                    break  # chunk tokens past the end are dropped
        return True

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
