"""Wrappers of the CUDA flash-attention kernels: K7, the forward
(``csrc/flash_attention.cu``), and K7b, its backward
(``csrc/flash_attention_bwd.cu``).

Each library builds at its first call (``kernels.build``) and binds through
``ctypes``. :func:`flash_attention` checks device, dtype, shape and
contiguity and what the kernel's TMA copies need (16-byte aligned bases;
every stride is then a multiple of 128 bytes), allocates the output (and the
row log-sum-exp when asked), launches on the current stream, raises on a
launch error, and adds one to :data:`launches` for each launch.
:func:`flash_attention_bwd` does the same for the gradients, with the
scratch its kernels share (the rows' statistics, and the scaled query at hd
128); its one call launches three kernels (the prep, then dk/dv, then dq)
and counts three.
There is no fallback and no copy: they take CUDA bf16 tensors with head dim
64 or 128 only, and raise on anything else (``kernels.ops`` routes CPU
tensors to the plain versions, ``kernels.ref.flash_attention`` and
``kernels.ref.flash_attention_bwd``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Launches since the last reset_launches(); ``flash_unsharded`` counts the
# attention calls under a mesh that ran whole because their rows or heads did
# not divide the shards (``models.common``), not a kernel.
launches = {"flash_attention": 0, "flash_attention_bwd": 0,
            "flash_unsharded": 0}

HEAD_DIMS = (64, 128)
# The kernel's work unit is QUERY_TILE query rows of one (batch, head); units
# are numbered in int32.
QUERY_TILE = 64
_MAX_UNITS = 2 ** 31 - 1
# A TMA tensor map takes dimensions below 2^32 and byte strides below 2^40.
_TMA_MAX_DIM = 2 ** 32 - 1
_TMA_MAX_STRIDE = 2 ** 40 - 1
# K7b's work units: BWD_UNIT rows of one (batch, head), keys of a kv head
# for dk/dv, queries of a query head for dq, numbered in int32. A call
# launches BWD_KERNELS kernels: the prep (the rows' log-sum-exp and D, and
# the scaled query at hd 128), dk/dv and dq.
BWD_UNIT = 128
BWD_KERNELS = 3

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    build.reset(launches)


def library() -> ctypes.CDLL:
    """The built and bound kernel library (built on first use)."""
    return build.load("flash_attention", _bind)


def backward_library() -> ctypes.CDLL:
    """The built and bound K7b library (built on first use)."""
    return build.load("flash_attention_bwd", _bind_bwd)


def _bind() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build("flash_attention")))
    lib.flash_attention_fwd.argtypes = [_P] * 5 + [_I] * 8 \
        + [ctypes.c_float, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


def _bind_bwd() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build("flash_attention_bwd")))
    lib.flash_attention_bwd.argtypes = [_P] * 11 + [_I] * 8 \
        + [ctypes.c_float, _P]
    lib.flash_attention_bwd.restype = _I
    return lib


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


def check_units(b: int, s: int, h: int, tile: int = QUERY_TILE) -> None:
    """Raises where a kernel cannot number the work units of ``tile`` rows
    of a (B, S, H) tensor in int32 (K7: query tiles of :data:`QUERY_TILE`;
    K7b: :data:`BWD_UNIT` queries or keys)."""
    units = -(-s // tile) * b * h
    if units > _MAX_UNITS:
        raise ValueError(f"{units} work units (ceil({s}/{tile}) x {b} x {h}) "
                         f"exceed the kernel's int32 unit index")


def _check_bf16(q: torch.Tensor, named: tuple) -> None:
    for name, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"{tuple(t.shape)}")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int | None) -> None:
    """K7's contract on q (B, S, H, hd) and k, v (B, T, Kv, hd)."""
    _check_bf16(q, (("q", q), ("k", k), ("v", v)))
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


def _raise_on(name: str, err: int) -> None:
    if err < 0:
        raise RuntimeError(f"{name}: TMA tensor map encoding failed "
                           f"(CUresult {-err})")
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    return_lse: bool = False):
    """CUDA kernel K7 — see ``kernels.ref.flash_attention``. q (B, S, H, hd),
    k and v (B, T, Kv, hd): contiguous bf16 on one CUDA device, hd in
    :data:`HEAD_DIMS`, H a multiple of Kv, T >= 1; ``window`` None or >= 1.
    With ``return_lse`` returns ``(out, lse)``, lse the rows' log-sum-exp
    (B, H, S) fp32 that K7b reads."""
    _check_qkv(q, k, v, window)
    b, s, h, hd = q.shape
    t_len, kvh = k.shape[1], k.shape[2]
    check_units(b, s, h)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b and s and h:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_operand(name, t)
        with torch.cuda.device(q.device):
            err = library().flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, t_len, h, kvh,
                hd, int(causal), window or 0, 1.0 / float(hd) ** 0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on("flash_attention", err)
        build.count(launches, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA kernel K7b — see ``kernels.ref.flash_attention_bwd``: (dq, dk,
    dv) of K7's output ``o`` under the cotangent ``do`` (both (B, S, H, hd),
    contiguous bf16), from q, k, v as K7 takes them and K7's ``lse`` (B, H,
    S) contiguous fp32. q, k, v and do must suit the kernels' TMA tensor maps
    (:func:`check_tma_operand`) and o start on a 16-byte boundary; the work
    units must be numbered in int32 (:func:`check_units`). Raises on
    anything else."""
    _check_qkv(q, k, v, window)
    _check_bf16(q, (("o", o), ("do", do)))
    b, s, h, hd = q.shape
    t_len, kvh = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    if lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (b, h, s) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {s}) fp32 "
                         f"tensor on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    check_units(b, s, h, BWD_UNIT)
    check_units(b, t_len, kvh, BWD_UNIT)
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    if b and s and h:
        # the rows' (lse log2(e), D), padded to whole query tiles, then the
        # two kernels' unit counters (int32, zeroed by the prep kernel); the
        # scaled query where the scale 1/sqrt(hd) is not a power of two
        s_pad = -(-s // QUERY_TILE) * QUERY_TILE
        stats = torch.empty(b * h * s_pad * 2 + 2, dtype=torch.float32,
                            device=q.device)
        qs = torch.empty_like(q) if hd == 128 else None
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do),
                        ("qs", qs)):
            if t is not None:
                check_tma_operand(name, t)
        if o.data_ptr() % 16:
            raise ValueError(f"o must start on a 16-byte boundary, got "
                             f"address {o.data_ptr():#x}")
        with torch.cuda.device(q.device):
            err = backward_library().flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                None if qs is None else qs.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, s, t_len, h, kvh, hd,
                int(causal), window or 0, 1.0 / float(hd) ** 0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on("flash_attention_bwd", err)
        build.count(launches, "flash_attention_bwd", BWD_KERNELS)
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv
