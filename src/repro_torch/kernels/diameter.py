"""Wrapper of the CUDA tuple-diameter kernel K6 (``csrc/diameter.cu``).

The library builds at the first call (``kernels.build``) and binds through
``ctypes``. :func:`tuple_diameters` checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises on a
launch error, and adds one to :data:`launches` for each launch. There is no
fallback: it takes contiguous CUDA fp32 (T, q, d) tensors with 1 <= q <= 9
and d >= 1 only, and raises on anything else (``kernels.ops`` routes CPU
tensors to the plain version, ``kernels.ref.tuple_diameters``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Launches since the last reset_launches().
launches = {"tuple_diameters": 0}

MAX_Q = 9

_LIB: ctypes.CDLL | None = None
_P = ctypes.c_void_p


def reset_launches() -> None:
    launches["tuple_diameters"] = 0


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build.build("diameter")))
        lib.tuple_diameters.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, _P, _P]
        lib.tuple_diameters.restype = ctypes.c_int
        lib.tuple_diameters_max_q.argtypes = []
        lib.tuple_diameters_max_q.restype = ctypes.c_int
        if lib.tuple_diameters_max_q() != MAX_Q:
            raise RuntimeError("kernel's largest q differs from MAX_Q")
        _LIB = lib
    return _LIB


def tuple_diameters(pts: torch.Tensor) -> torch.Tensor:
    """CUDA kernel K6 — see ``kernels.ref.tuple_diameters``. pts (T, q, d):
    contiguous fp32 on a CUDA device, 1 <= q <= :data:`MAX_Q`, d >= 1.
    Returns (T,) fp32."""
    if pts.device.type != "cuda":
        raise ValueError(f"pts must be a CUDA tensor, got {pts.device}")
    if pts.dtype != torch.float32:
        raise TypeError(f"pts must be torch.float32, got {pts.dtype}")
    if pts.dim() != 3 or not pts.is_contiguous():
        raise ValueError(f"pts must be a contiguous (T, q, d) tensor, got "
                         f"{tuple(pts.shape)}")
    t, q, d = pts.shape
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"tuples of {q} points not supported (kernel takes "
                         f"1..{MAX_Q})")
    if d < 1:
        raise ValueError("pts must have at least one feature")
    out = torch.empty(t, dtype=torch.float32, device=pts.device)
    if t:
        with torch.cuda.device(pts.device):
            err = library().tuple_diameters(
                pts.data_ptr(), t, q, d, out.data_ptr(),
                torch.cuda.current_stream(pts.device).cuda_stream)
        if err:
            raise RuntimeError(f"tuple_diameters: kernel launch failed with "
                               f"CUDA error {err}")
        launches["tuple_diameters"] += 1
    return out
