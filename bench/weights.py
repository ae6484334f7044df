"""The benchmark's weights, made from ``--seed`` on the device.

Every leaf is cut into flat chunks of ``CHUNK`` elements, and chunk ``c``
of leaf ``i`` (leaves in sorted path order) is drawn by its own
``torch.Generator`` seeded from ``(seed, i, c)``: so any chunk can be made
again alone, and the reference gets the program's weights without taking
them from the program. Norm scales are ones; every other leaf is normal
with the configuration's ``initializer_range``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

CHUNK = 1 << 26


def is_norm(path: str) -> bool:
    return "norm" in path.rsplit("/", 1)[-1]


def _generator(seed: int, leaf: int, chunk: int, device) -> torch.Generator:
    words = np.random.SeedSequence([int(seed), leaf, chunk]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 32 | int(words[1]))
    return g


def chunks(n: int) -> Iterator[Tuple[int, int, int]]:
    for c, a in enumerate(range(0, n, CHUNK)):
        yield c, a, min(n, a + CHUNK)


def fill_chunk(out: torch.Tensor, path: str, leaf: int, chunk: int, seed: int,
               std: float) -> torch.Tensor:
    """Write chunk ``chunk`` of leaf ``leaf`` into the flat tensor ``out``."""
    if is_norm(path):
        return out.fill_(1.0)
    return out.normal_(0.0, std, generator=_generator(seed, leaf, chunk, out.device))


@torch.no_grad()
def fill(params: Dict[str, torch.Tensor], seed: int, std: float) -> None:
    """Fill contiguous fp32 leaves in place."""
    for i, path in enumerate(sorted(params)):
        flat = params[path].view(-1)
        for c, a, b in chunks(flat.numel()):
            fill_chunk(flat[a:b], path, i, c, seed, std)


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, std: float, device
         ) -> Dict[str, torch.Tensor]:
    params = {k: torch.empty(s, dtype=torch.float32, device=device) for k, s in shapes.items()}
    fill(params, seed, std)
    return params


@torch.no_grad()
def change_norm(path: str, p: torch.Tensor, paths, seed: int, std: float) -> float:
    """``||p - p0||`` of leaf ``path``, ``p0`` made again chunk by chunk."""
    leaf = sorted(paths).index(path)
    flat = p.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=p.device)
    for c, a, b in chunks(flat.numel()):
        p0 = fill_chunk(torch.empty(b - a, dtype=torch.float32, device=p.device), path, leaf, c,
                        seed, std)
        total += torch.sum((flat[a:b] - p0).to(torch.float64) ** 2)
    return float(torch.sqrt(total))
