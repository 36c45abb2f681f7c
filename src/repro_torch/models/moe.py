"""Mixture-of-experts feed-forward with capacity-based sorted dispatch.

The port of the reference package's ``models/moe.py``. Each batch row ranks
its token slots per expert by one stable sort, packs them into a dense
(E, C, D) buffer (capacity C; slots past it are dropped, as in Switch and
GShard), runs the experts as batched matrix products and combines the
outputs with the top-k router weights. The reference pins heavy experts to
its tensor-parallel axis; on one card there is nothing to pin.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import Params, apply_mlp, dense_init, init_mlp


def init_moe(gen: torch.Generator, d: int, cfg: MoEConfig) -> Params:
    """Router (D, E) in fp32 (the reference reads it in fp32) and the
    experts' swiglu weights (E, D, F), (E, D, F), (E, F, D) in bf16, drawn
    expert by expert so that no whole fp32 stack is ever held."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    router = torch.randn((d, e), generator=gen, device=gen.device) * 0.02
    p: Params = {"router": router}
    for name, shape in (("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d))):
        w = torch.empty((e, *shape), dtype=torch.bfloat16, device=gen.device)
        for i in range(e):
            w[i] = dense_init(gen, shape)
        p[name] = w
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, d, f, "swiglu")
    return p


def capacity(s: int, cfg: MoEConfig) -> int:
    """Slots an expert takes per batch row: Python's round, as the
    reference."""
    return int(max(1, round(s * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


# While a sharded train step runs its data-parallel shards (``launch.step``):
# (keys {id(router tensor): key}, table {key: (expert counts, slots)},
# record), else None. See :func:`whole_batch_balance`.
_balance: tuple | None = None


@contextlib.contextmanager
def whole_batch_balance(keys: dict, table: dict, *, record: bool):
    """While it is open, a router ``r`` that ``keys`` names (by
    ``id(r)``) shares its slot fractions f_e across the shards of one
    batch. With ``record``, each call adds its expert counts and slots to
    ``table[keys[id(r)]]``; without, its f_e is the table's counts over
    its slots: the whole batch's. The aux loss ``E sum_e f_e P_e`` is a
    product of means, so a shard's own f_e would not give the whole
    batch's loss; with the whole batch's f_e (which carries no gradient)
    the row-weighted sum of the shards' aux losses is the whole batch's,
    and so is its gradient."""
    global _balance
    saved, _balance = _balance, (keys, table, record)
    try:
        yield
    finally:
        _balance = saved


def route(p: Params, x: torch.Tensor, cfg: MoEConfig):
    """Router probabilities (B, S, E) in fp32, the top-k weights
    (renormalised) and experts (B, S, k), and the load-balance aux loss
    ``aux_w * E * sum_e f_e P_e`` (Switch; f_e the whole batch's inside
    :func:`whole_batch_balance`)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = torch.bincount(top_e.reshape(-1), minlength=e).float()
    f_e = counts / (b * s * k)
    if _balance is not None:
        keys, table, record = _balance
        key = keys[id(p["router"])]
        if record:
            c, n = table.get(key, (None, 0))
            table[key] = (counts if c is None else c.to(counts.device)
                          + counts, n + b * s * k)
        else:
            c, n = table[key]
            f_e = c.to(counts.device) / n
    p_e = probs.mean(dim=(0, 1))
    aux = cfg.aux_loss_weight * e * (f_e * p_e).sum()
    return probs, top_w, top_e, aux


def apply_moe(p: Params, x: torch.Tensor, cfg: MoEConfig,
              stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss, fp32 scalar).

    Dispatch is per batch row, as in the reference: the S*k slots of a row,
    stably sorted by expert, take the expert's next free slot until its
    capacity is full; the rest are dropped. ``stats``, when given, gains
    ``"dropped"`` (slots over capacity) and ``"slots"`` (all slots)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(s, cfg)
    _, top_w, top_e, aux = route(p, x, cfg)

    slot_e = top_e.reshape(b, s * k)
    order = torch.argsort(slot_e, dim=-1, stable=True)       # (B, S*k)
    se = torch.gather(slot_e, 1, order)
    st = order // k                                           # slot's token
    counts = torch.zeros(b, e, dtype=torch.int64, device=x.device) \
        .scatter_add_(1, se, torch.ones_like(se))
    starts = counts.cumsum(1) - counts
    pos = torch.arange(s * k, device=x.device) - torch.gather(starts, 1, se)
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, e * cap)         # overflow row
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
        stats["slots"] = stats.get("slots", 0) + b * s * k

    # every kept slot owns its (expert, position) row: the buffer is a copy
    rows = torch.gather(x, 1, st[..., None].expand(b, s * k, d))
    buf = torch.zeros(b, e * cap + 1, d, dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(b, s * k, d), rows)
    buf = buf[:, :-1].reshape(b, e, cap, d).transpose(0, 1) \
        .reshape(e, b * cap, d)

    dt = x.dtype
    h = F.silu(torch.bmm(buf, p["w1"].to(dt))) * torch.bmm(buf, p["w3"].to(dt))
    out_e = torch.bmm(h, p["w2"].to(dt))                      # (E, B*cap, D)
    flat = out_e.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    gathered = torch.gather(
        flat, 1, dest.clamp_max(e * cap - 1)[..., None].expand(b, s * k, d))
    sw = torch.gather(top_w.reshape(b, s * k), 1, order)
    contrib = torch.where(keep[..., None], gathered, 0.0) \
        * sw[..., None].to(dt)
    # back to (token, rank) order; the k contributions summed in bf16
    unsorted = torch.empty_like(contrib).scatter_(
        1, order[..., None].expand(b, s * k, d), contrib).reshape(b, s, k, d)
    out = torch.zeros(b, s, d, dtype=dt, device=x.device)
    for j in range(k):
        out = out + unsorted[:, :, j]
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, "swiglu")
    return out, aux
