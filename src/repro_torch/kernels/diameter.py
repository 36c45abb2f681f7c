"""Wrappers of the CUDA kernels of ``csrc/diameter.cu`` (K6): the fused
anchor-star search and the standalone tuple diameters.

The library builds at the first call (``kernels.build``) and binds through
``ctypes``. Each wrapper checks device, dtype, shape and contiguity,
allocates its outputs and scratch, launches on the current stream, raises on
a launch error, and adds one to :data:`launches` for each kernel it
launches. There is no fallback: they take CUDA tensors only and raise on
anything else (``kernels.ops`` routes CPU tensors to the plain versions,
``kernels.ref.anchor_star`` and ``kernels.ref.tuple_diameters``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Kernel launches since the last reset_launches(): ``anchor_star`` counts
# both of its kernels (the neighbour stage, for q >= 2, and the diameter
# stage).
launches = {"tuple_diameters": 0, "anchor_star": 0}

MAX_Q = 9
# The most points a group may hold (the kernel's bitmap of anchor tiles).
MAX_R = 1 << 23

_LIB: ctypes.CDLL | None = None
_P = ctypes.c_void_p


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build.build("diameter")))
        lib.tuple_diameters.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, _P, _P]
        lib.tuple_diameters.restype = ctypes.c_int
        lib.anchor_star.argtypes = [_P, _P] + [ctypes.c_int] * 4 \
            + [_P] * 5
        lib.anchor_star.restype = ctypes.c_int
        for name in ("tuple_diameters_max_q", "anchor_star_max_r"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if lib.tuple_diameters_max_q() != MAX_Q \
                or lib.anchor_star_max_r() != MAX_R:
            raise RuntimeError("kernel's largest q or R differs from "
                               "MAX_Q or MAX_R")
        _LIB = lib
    return _LIB


def _check_q(q: int) -> None:
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"tuples of {q} points not supported (kernel takes "
                         f"1..{MAX_Q})")


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
    _check_q(q)
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


def anchor_star(groups: torch.Tensor, mask: torch.Tensor, *,
                tiles_per_unit: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused anchor-star kernel — see ``kernels.ref.anchor_star``.

    groups (q, R, d) contiguous fp32 and mask (q, R) contiguous bool, both
    on one CUDA device, 1 <= q <= :data:`MAX_Q`, 1 <= R <= :data:`MAX_R`,
    d >= 1. Returns (nn (R, q) int32, worst_nn (R,) fp32, diam (R,) fp32).
    Rows of anchors outside ``mask[0]`` are unspecified where their whole
    128-anchor tile is masked (the kernel skips it: nn 0, worst_nn BIG).
    ``tiles_per_unit`` > 0 fixes how many 128-point column tiles (at most 32) one unit of the
    neighbour stage covers (the split of R across blocks; 0 chooses from
    the shape)."""
    if groups.device.type != "cuda" or mask.device != groups.device:
        raise ValueError(f"groups and mask must be on one CUDA device, got "
                         f"{groups.device} and {mask.device}")
    if groups.dtype != torch.float32:
        raise TypeError(f"groups must be torch.float32, got {groups.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be torch.bool, got {mask.dtype}")
    if groups.dim() != 3 or not groups.is_contiguous() \
            or not mask.is_contiguous():
        raise ValueError(f"groups must be a contiguous (q, R, d) tensor and "
                         f"mask contiguous, got {tuple(groups.shape)}")
    q, r, d = groups.shape
    _check_q(q)
    if tuple(mask.shape) != (q, r):
        raise ValueError(f"mask must be (q, R) = {(q, r)}, got "
                         f"{tuple(mask.shape)}")
    if not 1 <= r <= MAX_R or d < 1:
        raise ValueError(f"need 1 <= R <= {MAX_R} and d >= 1, got R={r}, "
                         f"d={d}")
    dev = groups.device
    keys = torch.empty((r, max(q - 1, 1)), dtype=torch.int64, device=dev)
    nn = torch.empty((r, q), dtype=torch.int32, device=dev)
    worst = torch.empty(r, dtype=torch.float32, device=dev)
    diam = torch.empty(r, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().anchor_star(
            groups.data_ptr(), mask.data_ptr(), q, r, d, int(tiles_per_unit),
            keys.data_ptr(), nn.data_ptr(), worst.data_ptr(),
            diam.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"anchor_star: kernel launch failed with CUDA "
                           f"error {err}")
    launches["anchor_star"] += 2 if q > 1 else 1
    return nn, worst, diam
