"""Carry a built corpus, an index or model parameters across as plain arrays.

The serving state is the corpus and the two ProMiSH indices; the embedder's
is the language model's parameters. These constructors rebuild that state
from plain numpy arrays — what any other implementation (or a file) can hand
over — so an engine answers, and a model embeds, as the one the arrays were
read from.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.index import BucketSynopsis, HIStructure, PromishIndex
from repro_torch.core.types import KeywordDataset, dataset_from_csr
from repro_torch.utils.csr import CSR


def _csr(offsets, values) -> CSR:
    return CSR(offsets=np.ascontiguousarray(offsets, dtype=np.int64),
               values=np.ascontiguousarray(values))


def dataset_from_arrays(points: np.ndarray, kw_offsets: np.ndarray,
                        kw_values: np.ndarray,
                        n_keywords: int) -> KeywordDataset:
    """(N, d) points and the point -> keywords CSR (sorted unique rows)."""
    kw = _csr(kw_offsets, np.asarray(kw_values, dtype=np.int32))
    if kw.n_rows != len(points):
        raise ValueError(f"{len(points)} points but {kw.n_rows} keyword rows")
    return dataset_from_csr(points, kw, n_keywords)


def index_from_arrays(z: np.ndarray, p_max: float, n_scales: int,
                      exact: bool, scales: Sequence[dict]) -> PromishIndex:
    """A :class:`PromishIndex` from its arrays: the (m, d) projection
    vectors, the projection span and, per scale, ``width``, ``n_buckets``
    and the two CSRs (``table_offsets``/``table_values`` bucket -> points,
    ``khb_offsets``/``khb_values`` keyword -> buckets), and optionally
    ``synopsis``, the keyword arguments of its
    :class:`~repro_torch.core.index.BucketSynopsis` (the synopsis is carried
    with its tables: the planner's prunes read it, and a compaction rebuilds
    it only where the engine's build params ask for one)."""
    if len(scales) != n_scales:
        raise ValueError(f"{n_scales} scales but {len(scales)} given")
    structures = tuple(
        HIStructure(scale=s, width=float(sc["width"]),
                    n_buckets=int(sc["n_buckets"]),
                    table=_csr(sc["table_offsets"], sc["table_values"]),
                    khb=_csr(sc["khb_offsets"], sc["khb_values"]),
                    synopsis=BucketSynopsis(**sc["synopsis"])
                    if sc.get("synopsis") is not None else None)
        for s, sc in enumerate(scales))
    return PromishIndex(z=np.ascontiguousarray(z, dtype=np.float32),
                        w0=structures[0].width, n_scales=int(n_scales),
                        exact=bool(exact), structures=structures,
                        p_max=float(p_max))


def index_to_arrays(index: PromishIndex) -> dict:
    """The keyword arguments of :func:`index_from_arrays` for ``index``."""
    return dict(z=index.z, p_max=index.p_max, n_scales=index.n_scales,
                exact=index.exact,
                scales=[dict(width=h.width, n_buckets=h.n_buckets,
                             table_offsets=h.table.offsets,
                             table_values=h.table.values,
                             khb_offsets=h.khb.offsets,
                             khb_values=h.khb.values,
                             synopsis=None if h.synopsis is None
                             else dataclasses.asdict(h.synopsis))
                        for h in index.structures])


# Parameters held in fp32 (the norms' weights, which the forward reads in
# fp32); every other leaf is a matrix or bias the forward casts to bf16.
_FP32_LEAVES = ("w", "b", "qn", "kn")


def _leaf(name: str, a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.tensor(np.asarray(a, dtype=np.float32))
    dtype = torch.float32 if name in _FP32_LEAVES else torch.bfloat16
    return t.to(device=device, dtype=dtype)


def model_params_from_numpy(cfg: ArchConfig, tree: dict, *,
                            device: str | torch.device | None = None) -> dict:
    """The port's parameters, on ``device`` (the card unless the caller
    asks for another), from a dense model's parameter tree as numpy arrays:
    fp32 leaves, the layers stacked on a leading axis (the layout of the
    reference's ``init_params``). Matrices and biases become bf16 — the
    value the forward casts them to at every use — and norm weights stay
    fp32. The layer stack becomes a list of per-layer dictionaries. An
    untied output head is not carried: the embedding forward never reads
    it."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family}: dense only")
    device = resolve_device(device)

    def convert(node, index=None):
        return {k: convert(v, index) if isinstance(v, dict)
                else _leaf(k, v if index is None else v[index], device)
                for k, v in node.items()}

    stacked = tree["layers"]
    n = len(stacked["ln1"]["w"])
    if n != cfg.n_layers:
        raise ValueError(f"{n} stacked layers, config has {cfg.n_layers}")
    return {"embed": {"tok": _leaf("tok", tree["embed"]["tok"], device)},
            "final_norm": convert(tree["final_norm"]),
            "layers": [convert(stacked, i) for i in range(n)]}
