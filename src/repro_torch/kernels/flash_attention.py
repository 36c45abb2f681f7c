"""Wrapper of the CUDA flash-attention kernel K7 (``csrc/flash_attention.cu``).

The library builds at the first call (``kernels.build``) and binds through
``ctypes``. :func:`flash_attention` checks device, dtype, shape and
contiguity and what the kernel's TMA copies need (16-byte aligned bases;
every stride is then a multiple of 128 bytes), allocates the output,
launches on the current stream, raises on a launch error, and adds one to
:data:`launches` for each launch. There is no fallback and no copy: it takes
CUDA bf16 tensors with head dim 64 or 128 only, and raises on anything else
(``kernels.ops`` routes CPU tensors to the plain version,
``kernels.ref.flash_attention``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Launches since the last reset_launches().
launches = {"flash_attention": 0}

HEAD_DIMS = (64, 128)
# The kernel's work unit is QUERY_TILE query rows of one (batch, head); units
# are numbered in int32.
QUERY_TILE = 64
_MAX_UNITS = 2 ** 31 - 1
# A TMA tensor map takes dimensions below 2^32 and byte strides below 2^40.
_TMA_MAX_DIM = 2 ** 32 - 1
_TMA_MAX_STRIDE = 2 ** 40 - 1

_LIB: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches["flash_attention"] = 0


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build.build("flash_attention")))
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 8 \
            + [ctypes.c_float, _P]
        lib.flash_attention_fwd.restype = _I
        _LIB = lib
    return _LIB


def check_tma_operand(name: str, t: torch.Tensor) -> None:
    """Raises unless the kernel's 4-d tensor map can describe ``t``, a
    contiguous (B, rows, heads, hd) bf16 tensor: a 16-byte aligned base, and
    dimensions and byte strides within TMA's limits. Nothing is copied to
    make a tensor fit."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for TMA, "
                         f"got address {t.data_ptr():#x}")
    if max(t.shape) > _TMA_MAX_DIM \
            or t.element_size() * t[0].numel() > _TMA_MAX_STRIDE:
        raise ValueError(f"{name} {tuple(t.shape)} exceeds the TMA tensor "
                         f"map's limits")


def check_units(b: int, s: int, h: int) -> None:
    """Raises where the kernel cannot number the work units of a
    (B, S, H) query in int32."""
    units = -(-s // QUERY_TILE) * b * h
    if units > _MAX_UNITS:
        raise ValueError(f"{units} work units (ceil(S/{QUERY_TILE}) x B x H) "
                         f"exceed the kernel's int32 unit index")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """CUDA kernel K7 — see ``kernels.ref.flash_attention``. q (B, S, H, hd),
    k and v (B, T, Kv, hd): contiguous bf16 on one CUDA device, hd in
    :data:`HEAD_DIMS`, H a multiple of Kv, T >= 1; ``window`` None or >= 1.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"{tuple(t.shape)}")
    b, s, h, hd = q.shape
    t_len, kvh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t_len, kvh, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, T, Kv, {hd}) with B={b}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (kernel takes "
                         f"{HEAD_DIMS})")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv "
                         f"heads")
    if t_len == 0:
        raise ValueError("attention over no keys")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_units(b, s, h)
    out = torch.empty_like(q)
    if b and s and h:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_operand(name, t)
        with torch.cuda.device(q.device):
            err = library().flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
                t_len, h, kvh, hd, int(causal), window or 0,
                1.0 / float(hd) ** 0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
        if err < 0:
            raise RuntimeError(f"flash_attention: TMA tensor map encoding "
                               f"failed (CUresult {-err})")
        if err:
            raise RuntimeError(f"flash_attention: kernel launch failed with "
                               f"CUDA error {err}")
        launches["flash_attention"] += 1
    return out
