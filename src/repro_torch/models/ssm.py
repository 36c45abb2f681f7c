"""Mamba2 (SSD, state-space duality) sequence mixer.

The port of the reference package's ``models/ssm.py``. The sequence is cut
into chunks of length Q; inside a chunk the recurrence is expanded into a
(Q, Q) lower-triangular matrix applied by matrix products, and the chunks
are stitched by a small (B, H, P, N) state recurrence. The big products take
bf16 operands and keep fp32 results (the reference's
``preferred_element_type=float32``); the decay and softplus statistics stay
fp32. Decode is O(1): one state update a token, no KV cache.

Parameters as in the reference: separate z/x/B/C/dt projections, depthwise
conv taps and biases, ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_w``. The
conv taps and biases, ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_w`` are
held in fp32: the one-token conv step reads the taps in fp32, while the
whole-sequence conv rounds them to bf16 at use, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.common import (ACT_DTYPE, Params, dense_init,
                                       f32_dot, rmsnorm)


def dims(d_model: int, cfg: SSMConfig) -> dict:
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    return {"d_in": d_in, "n_heads": n_heads, "gn": cfg.n_groups * cfg.d_state}


def init_ssm(gen: torch.Generator, d_model: int, cfg: SSMConfig) -> Params:
    dm = dims(d_model, cfg)
    d_in, h, gn = dm["d_in"], dm["n_heads"], dm["gn"]
    dev = gen.device

    def taps(c):
        return torch.randn((cfg.d_conv, c), generator=gen, device=dev) * 0.1

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return {
        "z_proj": dense_init(gen, (d_model, d_in)),
        "x_proj": dense_init(gen, (d_model, d_in)),
        "b_proj": dense_init(gen, (d_model, gn)),
        "c_proj": dense_init(gen, (d_model, gn)),
        "dt_proj": dense_init(gen, (d_model, h)),
        "conv_x": taps(d_in), "conv_b": taps(gn), "conv_c": taps(gn),
        "conv_bias_x": full(d_in, 0.0), "conv_bias_b": full(gn, 0.0),
        "conv_bias_c": full(gn, 0.0),
        "a_log": full(h, 0.0),            # A = -exp(a_log) = -1
        "d_skip": full(h, 1.0),
        "dt_bias": full(h, 0.0),
        "norm_w": full(d_in, 1.0),
        "out_proj": dense_init(gen, (d_in, d_model)),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C), width K (K-1 zeros on the
    left), taps and bias rounded to u's dtype, then SiLU; bf16 throughout
    as in the reference."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i].to(u.dtype)
    return F.silu(out + bias.to(u.dtype))


def _conv_step(u_t: torch.Tensor, window: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token conv: ``window`` (B, K-1, C) the raw history, ``u_t``
    (B, C) the raw input. Returns (SiLU of the conv in fp32 (B, C), the new
    window)."""
    win = torch.cat([window, u_t[:, None, :]], dim=1)            # (B, K, C)
    out = torch.einsum("bkc,kc->bc", win.float(), w.float())
    return F.silu(out + bias.float()), win[:, 1:]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                c_in: torch.Tensor, a: torch.Tensor, *,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (B, S, H, P); dt (B, S, H) after the softplus;
    b_in, c_in (B, S, G, N); a (H,) negative. Returns y (B, S, H, P) fp32
    and the final state (B, H, P, N) fp32. S need not be a multiple of the
    chunk: the tail is padded with zeros (dt = 0 leaves the state alone)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    rep = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, 0, 0, pad))

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_in.reshape(bsz, nc, q, g, n)
    cc = c_in.reshape(bsz, nc, q, g, n)

    da = dtc * a.float()                                  # (B,nc,Q,H) < 0
    cum = torch.cumsum(da, dim=2)                         # inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Qi,Qj,H)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    # exp of the masked segment sums (0 above the diagonal): the same
    # values as where(tri, exp(seg), 0), without an overflowing exp there
    # whose infinite derivative would turn the masked gradient into NaN
    l_mat = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))

    # intra-chunk: y[i] = sum_{j<=i} (C_i . B_j) L_ij dt_j x_j
    cb = f32_dot("bcign,bcjgn->bcijg", cc, bc)            # (B,nc,Qi,Qj,G)
    cb = cb.repeat_interleave(rep, dim=4)                 # (B,nc,Qi,Qj,H)
    m_mat = (cb * l_mat * dtc[:, :, None, :, :]).to(ACT_DTYPE)
    y_intra = f32_dot("bcijh,bcjhp->bcihp", m_mat, xc)

    # chunk-end states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    bg = bc.repeat_interleave(rep, dim=3).float()         # (B,nc,Q,H,N)
    w_j = decay_end * dtc
    states = f32_dot("bcjhn,bcjhp->bchpn", bg * w_j[..., None], xc)

    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)
    carry = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    cg = cc.repeat_interleave(rep, dim=3).float()         # (B,nc,Q,H,N)
    y_inter = f32_dot("bcihn,bchpn->bcihp", cg * torch.exp(cum)[..., None],
                      prev_states)
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)[:, :s]
    return y, carry


def apply_ssm(p: Params, x: torch.Tensor, cfg: SSMConfig, *,
              state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Mamba2 mixer, x (B, S, D). The forward and prefill when ``state`` is
    None; a one-token decode step when ``state`` = {"cx", "cb", "cc" (raw
    conv windows, bf16), "ssm" (fp32)}. Returns (out (B, S, D), new
    state)."""
    bsz, s, d_model = x.shape
    dm = dims(d_model, cfg)
    d_in, h = dm["d_in"], dm["n_heads"]
    g, n, pdim = cfg.n_groups, cfg.d_state, cfg.head_dim
    dtp = x.dtype

    z = x @ p["z_proj"].to(dtp)
    xr = x @ p["x_proj"].to(dtp)                           # raw (pre-conv)
    br = x @ p["b_proj"].to(dtp)
    cr = x @ p["c_proj"].to(dtp)
    dt_raw = x @ p["dt_proj"].to(dtp)
    a = -torch.exp(p["a_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if state is None:
        xs = _causal_conv(xr, p["conv_x"], p["conv_bias_x"])
        bs_ = _causal_conv(br, p["conv_b"], p["conv_bias_b"])
        cs = _causal_conv(cr, p["conv_c"], p["conv_bias_c"])
        xs = xs.reshape(bsz, s, h, pdim)
        y, fin = ssd_chunked(xs, dt, bs_.reshape(bsz, s, g, n),
                             cs.reshape(bsz, s, g, n), a, chunk=cfg.chunk)
        k = cfg.d_conv

        def tail(u):
            return F.pad(u, (0, 0, k - 1, 0))[:, -(k - 1):, :]
        new_state = {"cx": tail(xr), "cb": tail(br), "cc": tail(cr),
                     "ssm": fin}
    else:
        xs_t, ncx = _conv_step(xr[:, 0], state["cx"], p["conv_x"],
                               p["conv_bias_x"])
        b_t, ncb = _conv_step(br[:, 0], state["cb"], p["conv_b"],
                              p["conv_bias_b"])
        c_t, ncc = _conv_step(cr[:, 0], state["cc"], p["conv_c"],
                              p["conv_bias_c"])
        rep = h // g
        xs0 = xs_t.reshape(bsz, h, pdim)
        bg = b_t.reshape(bsz, g, n).repeat_interleave(rep, dim=1)  # (B,H,N)
        cg = c_t.reshape(bsz, g, n).repeat_interleave(rep, dim=1)
        da = torch.exp(dt[:, 0] * a)                           # (B,H)
        st = state["ssm"] * da[:, :, None, None] \
            + (dt[:, 0, :, None] * xs0)[..., None] * bg[:, :, None, :]
        y = torch.einsum("bhn,bhpn->bhp", cg, st)[:, None]     # (B,1,H,P)
        xs = xs0[:, None]                                      # for the skip
        new_state = {"cx": ncx, "cb": ncb, "cc": ncc, "ssm": st}

    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(bsz, s, d_in).to(dtp)
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm_w"])
    return y @ p["out_proj"].to(dtp), new_state


def init_state(bsz: int, d_model: int, cfg: SSMConfig, *,
               device: torch.device, dtype=ACT_DTYPE) -> Params:
    """Zero decode state: the three raw conv windows and the SSD state."""
    dm = dims(d_model, cfg)
    k = cfg.d_conv - 1
    return {
        "cx": torch.zeros(bsz, k, dm["d_in"], dtype=dtype, device=device),
        "cb": torch.zeros(bsz, k, dm["gn"], dtype=dtype, device=device),
        "cc": torch.zeros(bsz, k, dm["gn"], dtype=dtype, device=device),
        "ssm": torch.zeros(bsz, dm["n_heads"], cfg.head_dim, cfg.d_state,
                           dtype=torch.float32, device=device),
    }
