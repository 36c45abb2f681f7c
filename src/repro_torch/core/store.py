"""Out-of-core columnar store: memory-mapped corpus and index, zone maps.

The on-disk layout is the reference package's, leaf for leaf (names,
dtypes, shapes, ``meta.json`` keys and the sha256 manifest), so a store
written by either package opens in the other:

  * **Columnar leaves** — one ``.npy`` per flat array (points, CSR keyword
    lists and their offsets sidecars, per-scale bucket tables), fsync'd at
    write and loadable either resident or memory-mapped
    (``np.load(mmap_mode="r")``). The engine keeps the keyword CSRs and the
    bucket tables mapped on the host for the planner; the points are read
    off their mapped leaf once, into the card, where the whole corpus stays
    resident (host float64 settlement still reads the mapped rows).
  * **Per-bucket synopses** (:class:`~repro_torch.core.index.BucketSynopsis`)
    — point counts, bounding radii, and per-attribute min/max zone maps,
    persisted as small resident leaves. :class:`ZoneMapPruner` turns a
    query's :class:`~repro_torch.core.filters.Filter` into per-bucket reject
    verdicts the planner applies before it reads a bucket's member list.
  * **Atomic store trees** — ``save_store``/``load_store`` write/read a full
    ``{dataset, index_e, index_a, build_params}`` tree with the same
    write-to-temp + fsync + rename discipline as WAL snapshots (the snapshot
    code in ``serve.wal`` builds on the same leaf helpers, which live here).
    :func:`build_store` builds the indices on the card
    (:func:`~repro_torch.core.index_build.build_indices`, K5) before it
    writes them.

Everything the pruner consults is a conservative superset of the bucket's
bulk contents, so pruning can only skip work: a zone-rejected bucket provably
holds no eligible point, and a bucket whose diameter bound already beats the
live ``r_k`` joins all-pairs anyway (the dispatcher's infinite-radius fast
path) — results are bit-identical with pruning on or off.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.index import BucketSynopsis, HIStructure, PromishIndex
from repro_torch.core.index_build import BuildStats, build_indices
from repro_torch.core.types import KeywordDataset, TenantNamespace
from repro_torch.utils.csr import CSR


def fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ------------------------------------------------------------------- leaf I/O
def save_arr(root: str, name: str, arr: np.ndarray, manifest: dict) -> None:
    arr = np.ascontiguousarray(arr)
    # fsync each leaf: the tree's atomicity story is write-to-temp + fsync +
    # rename, and once an older epoch is GC'd a page-cached-only leaf would
    # be the sole copy of acknowledged data.
    with open(os.path.join(root, f"{name}.npy"), "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    manifest[name] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                      "dtype": arr.dtype.str, "shape": list(arr.shape)}


def load_arr(root: str, name: str, manifest: dict, *, mmap: bool,
             verify: bool) -> np.ndarray:
    path = os.path.join(root, f"{name}.npy")
    try:
        arr = np.load(path, mmap_mode="r" if mmap else None)
    except (OSError, ValueError, EOFError) as e:
        # Missing, truncated, or header-corrupt leaf: surface one exception
        # type with enough context to name the damaged file.
        raise IOError(f"store leaf {name!r} unreadable at {path}: {e}") from e
    ent = manifest.get(name)
    if ent is not None and list(arr.shape) != list(ent["shape"]):
        raise IOError(f"store leaf {name!r} at {path} has shape "
                      f"{list(arr.shape)}, manifest says {ent['shape']} "
                      f"(truncated or tampered)")
    if verify:
        got = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
        if got != manifest[name]["sha256"]:
            raise IOError(f"store leaf {name!r} failed its checksum "
                          f"(root={root})")
    return arr


def save_csr(root: str, name: str, csr: CSR, manifest: dict) -> None:
    save_arr(root, f"{name}.offsets", csr.offsets, manifest)
    save_arr(root, f"{name}.values", csr.values, manifest)


def load_csr(root: str, name: str, manifest: dict, *, mmap: bool,
             verify: bool) -> CSR:
    return CSR(offsets=load_arr(root, f"{name}.offsets", manifest,
                                mmap=mmap, verify=verify),
               values=load_arr(root, f"{name}.values", manifest,
                               mmap=mmap, verify=verify))


# ------------------------------------------------------------ dataset / index
def save_dataset(root: str, dataset: KeywordDataset, manifest: dict) -> dict:
    """Persist a frozen corpus into ``root``; returns its meta dict."""
    save_arr(root, "points", dataset.points, manifest)
    save_csr(root, "kw", dataset.kw, manifest)
    save_csr(root, "ikp", dataset.ikp, manifest)
    meta = {"n": dataset.n, "dim": dataset.dim,
            "n_keywords": dataset.n_keywords,
            "attrs": sorted(dataset.attrs) if dataset.attrs else [],
            "tenant_of": dataset.tenant_of is not None, "tenants": None}
    for name in meta["attrs"]:
        save_arr(root, f"attr_{name}", dataset.attrs[name], manifest)
    if dataset.tenant_of is not None:
        save_arr(root, "tenant_of", dataset.tenant_of, manifest)
    if dataset.tenants is not None:
        meta["tenants"] = {
            "names": list(dataset.tenants.names),
            "kw_offsets": [int(v) for v in dataset.tenants.kw_offsets]}
    return meta


def load_dataset(root: str, meta: dict, manifest: dict, *, mmap: bool,
                 verify: bool) -> KeywordDataset:
    attrs = {name: np.asarray(load_arr(root, f"attr_{name}", manifest,
                                       mmap=mmap, verify=verify))
             for name in meta["attrs"]} or None
    tenant_of = load_arr(root, "tenant_of", manifest, mmap=mmap,
                         verify=verify) if meta["tenant_of"] else None
    tenants = None
    if meta["tenants"]:
        tenants = TenantNamespace(
            names=tuple(meta["tenants"]["names"]),
            kw_offsets=np.asarray(meta["tenants"]["kw_offsets"], np.int64))
    return KeywordDataset(
        points=load_arr(root, "points", manifest, mmap=mmap, verify=verify),
        kw=load_csr(root, "kw", manifest, mmap=mmap, verify=verify),
        ikp=load_csr(root, "ikp", manifest, mmap=mmap, verify=verify),
        n_keywords=int(meta["n_keywords"]), attrs=attrs,
        tenant_of=tenant_of, tenants=tenants)


def save_index(root: str, prefix: str, index: PromishIndex,
               manifest: dict) -> dict:
    """Persist one frozen index flavour under ``root`` with ``prefix``."""
    save_arr(root, f"{prefix}.z", index.z, manifest)
    scales = []
    for hi in index.structures:
        save_csr(root, f"{prefix}.s{hi.scale}.table", hi.table, manifest)
        save_csr(root, f"{prefix}.s{hi.scale}.khb", hi.khb, manifest)
        syn_meta = None
        if hi.synopsis is not None:
            syn = hi.synopsis
            base = f"{prefix}.s{hi.scale}.syn"
            save_arr(root, f"{base}.counts", syn.counts, manifest)
            save_arr(root, f"{base}.radius", syn.radius, manifest)
            for name in sorted(syn.attr_min):
                save_arr(root, f"{base}.min_{name}", syn.attr_min[name],
                         manifest)
                save_arr(root, f"{base}.max_{name}", syn.attr_max[name],
                         manifest)
            has_tenant = syn.tenant_min is not None
            if has_tenant:
                save_arr(root, f"{base}.tenant_min", syn.tenant_min, manifest)
                save_arr(root, f"{base}.tenant_max", syn.tenant_max, manifest)
            syn_meta = {"attrs": sorted(syn.attr_min), "tenant": has_tenant}
        scales.append({"scale": hi.scale, "width": hi.width,
                       "n_buckets": hi.n_buckets, "synopsis": syn_meta})
    return {"w0": index.w0, "n_scales": index.n_scales, "exact": index.exact,
            "p_max": index.p_max, "scales": scales}


def _load_synopsis(root: str, base: str, syn_meta: dict,
                   manifest: dict, *, verify: bool) -> BucketSynopsis:
    # Synopses are consulted per covering bucket on every query — always
    # resident (they are tiny next to the leaves they let us skip).
    def _r(name):
        return np.asarray(load_arr(root, f"{base}.{name}", manifest,
                                   mmap=False, verify=verify))
    attr_min = {name: _r(f"min_{name}") for name in syn_meta["attrs"]}
    attr_max = {name: _r(f"max_{name}") for name in syn_meta["attrs"]}
    tenant_min = tenant_max = None
    if syn_meta["tenant"]:
        tenant_min, tenant_max = _r("tenant_min"), _r("tenant_max")
    return BucketSynopsis(counts=_r("counts"), radius=_r("radius"),
                          attr_min=attr_min, attr_max=attr_max,
                          tenant_min=tenant_min, tenant_max=tenant_max)


def load_index(root: str, prefix: str, meta: dict, manifest: dict, *,
               mmap: bool, verify: bool) -> PromishIndex:
    structures = []
    for sc in meta["scales"]:
        syn_meta = sc.get("synopsis")
        syn = _load_synopsis(root, f"{prefix}.s{sc['scale']}.syn", syn_meta,
                             manifest, verify=verify) \
            if syn_meta is not None else None
        structures.append(HIStructure(
            scale=sc["scale"], width=sc["width"], n_buckets=sc["n_buckets"],
            table=load_csr(root, f"{prefix}.s{sc['scale']}.table", manifest,
                           mmap=mmap, verify=verify),
            khb=load_csr(root, f"{prefix}.s{sc['scale']}.khb", manifest,
                         mmap=mmap, verify=verify),
            synopsis=syn))
    return PromishIndex(
        z=load_arr(root, f"{prefix}.z", manifest, mmap=mmap, verify=verify),
        w0=meta["w0"], n_scales=meta["n_scales"], exact=meta["exact"],
        structures=tuple(structures), p_max=meta["p_max"])


# ------------------------------------------------------------ store trees
def save_store(directory: str, *, dataset: KeywordDataset,
               index_e: PromishIndex | None = None,
               index_a: PromishIndex | None = None,
               build_params: dict | None = None) -> str:
    """Atomically write a corpus + index tree to ``directory``.

    Same discipline as WAL snapshots: write-to-temp + per-leaf fsync +
    rename, so a crash mid-write can never leave a half store that
    ``load_store`` would pick up.
    """
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-store-", dir=parent)
    try:
        manifest: dict = {}
        meta = {
            "format": 1,
            "kind": "store",
            "dataset": save_dataset(tmp, dataset, manifest),
            "index_e": (save_index(tmp, "e", index_e, manifest)
                        if index_e is not None else None),
            "index_a": (save_index(tmp, "a", index_a, manifest)
                        if index_a is not None else None),
            "build_params": dict(build_params or {}),
            "leaves": manifest,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(tmp)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
        fsync_dir(parent)
        return directory
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_store(directory: str, *, mmap: bool = True,
               verify: bool = False) -> dict:
    """Load a store tree -> {dataset, index_e, index_a, build_params}.

    ``mmap=True`` (the default — the whole point of the store) maps every
    bulk leaf instead of reading it resident; ``verify=True`` checksums each
    leaf against the manifest (a full read, defeating laziness — meant for
    integrity audits, not serving).
    """
    meta_path = os.path.join(directory, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise IOError(f"store meta unreadable at {meta_path}: {e}") from e
    manifest = meta["leaves"]
    out = {
        "dataset": load_dataset(directory, meta["dataset"], manifest,
                                mmap=mmap, verify=verify),
        "index_e": None, "index_a": None,
        "build_params": meta.get("build_params", {}),
    }
    for flavour in ("e", "a"):
        imeta = meta[f"index_{flavour}"]
        if imeta is not None:
            out[f"index_{flavour}"] = load_index(
                directory, flavour, imeta, manifest, mmap=mmap, verify=verify)
    return out


def build_store(directory: str, dataset: KeywordDataset, *, m: int = 2,
                n_scales: int = 5, seed: int = 0, w0: float | None = None,
                n_buckets: int | None = None, build_exact: bool = True,
                build_approx: bool = True, synopsis: bool = True,
                device: str | torch.device | None = None,
                stats: BuildStats | None = None) -> str:
    """Build both index flavours (with synopses) over ``dataset`` and persist
    the whole tree — the bulk-load path of the out-of-core engine.

    The indices are built on ``device`` (the card unless the caller asks
    for another) by :func:`~repro_torch.core.index_build.build_indices`,
    equal array for array to the host build, with the synopses built on
    the host from the copied-back tables; phase walls accumulate in
    ``stats``. The recorded ``build_params`` are exactly the engine's pinned
    geometry (``m``/``n_scales``/``seed``/``w0``/``n_buckets``/``synopsis``),
    so an engine opened with
    :meth:`~repro_torch.serve.engine.NKSEngine.from_store` streams and
    compacts bit-identically to an engine built with the same parameters.
    """
    bp = dict(m=m, n_scales=n_scales, seed=seed, w0=w0, n_buckets=n_buckets,
              synopsis=synopsis)
    dev = resolve_device(device)
    points_dev = torch.from_numpy(
        np.ascontiguousarray(dataset.points, np.float32)).to(dev)
    index_e, index_a = build_indices(dataset, points_dev, stats=stats,
                                     build_exact=build_exact,
                                     build_approx=build_approx, **bp)
    del points_dev
    return save_store(directory, dataset=dataset, index_e=index_e,
                      index_a=index_a, build_params=bp)


def store_nbytes(directory: str) -> int:
    """Total on-disk size of the store's leaves (the cold-tier footprint)."""
    total = 0
    for name in os.listdir(directory):
        if name.endswith(".npy"):
            total += os.path.getsize(os.path.join(directory, name))
    return total


# ------------------------------------------------------------- zone-map prune
def _as_number(v) -> float | None:
    if isinstance(v, bool) or not isinstance(v, (int, float, np.integer,
                                                 np.floating)):
        return None
    return float(v)


class ZoneMapPruner:
    """Per-bucket reject verdicts for one filtered batch.

    Built once per ``query_batch`` from the batch's
    :class:`~repro_torch.core.filters.Filter`; :meth:`reject` is then
    consulted per scale with the covering-bucket list. A bucket is rejected only when some
    conjunctive clause is *provably empty* against the bucket's zone map —
    e.g. ``price < v`` rejects a bucket whose ``min(price) >= v``. Non-numeric
    clauses (categorical equality on string columns) and attributes without a
    zone map simply never reject; NaN bounds compare ``False`` everywhere, so
    they never reject either. Empty buckets carry inverted ranges
    (min=+inf, max=-inf) and reject under every clause — harmless, the
    planner would have skipped them on emptiness anyway.
    """

    def __init__(self, flt, dataset):
        self._clauses = []
        for c in (flt.clauses or ()):
            if c.op == "between":
                lo, hi = c.value
                ok = _as_number(lo) is not None and _as_number(hi) is not None
            elif c.op == "in":
                vals = list(c.value)
                ok = bool(vals) and all(_as_number(v) is not None
                                        for v in vals)
            else:
                ok = _as_number(c.value) is not None
            if ok:
                self._clauses.append(c)
        self._tenant: int | None = None
        if flt.tenant is not None:
            try:
                ns = getattr(dataset, "tenants", None)
                self._tenant = int(ns.id_of(flt.tenant)) if ns is not None \
                    else int(flt.tenant)
            except (KeyError, TypeError, ValueError):
                self._tenant = None      # evaluate() is the authority; no prune

    @property
    def active(self) -> bool:
        return bool(self._clauses) or self._tenant is not None

    def reject(self, synopsis: BucketSynopsis | None,
               buckets) -> np.ndarray | None:
        """Boolean reject mask aligned with ``buckets`` (True = provably no
        eligible point in the bucket's bulk part), or None when this scale
        has no synopsis to consult."""
        if synopsis is None or not self.active:
            return None
        b = np.asarray(buckets, dtype=np.int64)
        rej = np.zeros(len(b), dtype=bool)
        for c in self._clauses:
            amin_col = synopsis.attr_min.get(c.attr)
            if amin_col is None:
                continue
            amin, amax = amin_col[b], synopsis.attr_max[c.attr][b]
            op, v = c.op, c.value
            if op == "<":
                r = amin >= v
            elif op == "<=":
                r = amin > v
            elif op == ">":
                r = amax <= v
            elif op == ">=":
                r = amax < v
            elif op == "==":
                r = (v < amin) | (v > amax)
            elif op == "!=":
                # Only provably empty when the bucket is constant at v.
                r = (amin == v) & (amax == v)
            elif op == "between":
                lo, hi = c.value
                r = (amax < lo) | (amin > hi)
            else:                        # "in" (values normalised + sorted)
                r = (amax < c.value[0]) | (amin > c.value[-1])
            rej |= r
        if self._tenant is not None and synopsis.tenant_min is not None:
            rej |= (synopsis.tenant_max[b] < self._tenant) \
                | (synopsis.tenant_min[b] > self._tenant)
        return rej
