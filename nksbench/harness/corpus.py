"""The benchmark's corpora, made from the run's seed.

A configuration's ``corpus`` object names a generator,
``nksbench/corpora/<generator>.py``, whose ``make(seed=..., **params)``
returns a :class:`Corpus`. Generators are vectorised: the points are made
on the device with a ``torch.Generator`` seeded from the run's seed, in a
few large calls, and the tags on the host with numpy, in bulk, from the
same seed.

A :class:`Corpus` holds the point -> tags CSR and can remake its points
on any device (:meth:`Corpus.points`), so that the plain reference reads
the seed's data and nothing a program built from it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness.spec import BENCH, load_module

SEED_MOD = 1 << 63


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


def torch_gen(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    return gen


@dataclasses.dataclass
class Corpus:
    """A seeded corpus: (n, d) fp32 points (remade on demand) and the
    point -> tags CSR (``kw_offsets`` (n + 1,) int64, ``kw_values`` int32,
    each row sorted and unique)."""

    seed: int
    n: int
    d: int
    u: int
    kw_offsets: np.ndarray
    kw_values: np.ndarray
    _make_points: object = dataclasses.field(repr=False, default=None)
    _postings: tuple | None = dataclasses.field(repr=False, default=None)

    def points(self, device) -> torch.Tensor:
        """The (n, d) fp32 points on ``device``, made from the seed."""
        return self._make_points(torch.device(device))

    def posting_sizes(self) -> np.ndarray:
        """(u,) int64: how many points carry each tag."""
        return np.bincount(self.kw_values, minlength=self.u).astype(np.int64)

    def postings(self) -> tuple[np.ndarray, np.ndarray]:
        """tag -> points CSR ``(offsets (u + 1,), point ids)``, each row in
        ascending point id: the benchmark's own inverted index."""
        if self._postings is None:
            rows = np.repeat(np.arange(self.n, dtype=np.int64),
                             np.diff(self.kw_offsets))
            order = np.argsort(self.kw_values, kind="stable")
            offsets = np.zeros(self.u + 1, dtype=np.int64)
            np.cumsum(self.posting_sizes(), out=offsets[1:])
            self._postings = (offsets, rows[order])
        return self._postings

    def posting(self, tag: int) -> np.ndarray:
        offsets, ids = self.postings()
        return ids[offsets[tag]:offsets[tag + 1]]

    def tags_of(self, point: int) -> np.ndarray:
        return self.kw_values[self.kw_offsets[point]:self.kw_offsets[point + 1]]


def make_corpus(config: dict, seed: int) -> Corpus:
    """The corpus a configuration file describes (its ``corpus`` object:
    ``generator`` and that generator's keyword arguments)."""
    spec = dict(config["corpus"])
    name = spec.pop("generator")
    return load_module(BENCH / "corpora" / f"{name}.py").make(seed=seed,
                                                             **spec)
