"""Wrapper of the CUDA projection + binning kernel K5 (``csrc/project_bin.cu``).

The library builds at the first call (``kernels.build``) and binds through
``ctypes``. :func:`project_and_bin` checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream, raises on
a launch error, and adds one to :data:`launches` for each launch. There is
no fallback: it takes contiguous CUDA (N, d) fp32 or bf16 points and (m, d)
unit vectors with 1 <= m <= 8 only, and raises on anything else
(``kernels.ops`` routes CPU tensors to the plain version,
``kernels.ref.project_and_bin``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bin_constants

# Launches since the last reset_launches().
launches = {"project_and_bin": 0}

MAX_M = 8

_P = ctypes.c_void_p


def reset_launches() -> None:
    build.reset(launches)


def library() -> ctypes.CDLL:
    """The built and bound kernel library (built on first use)."""
    return build.load("project_bin", _bind)


def _bind() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build("project_bin")))
    lib.project_and_bin.argtypes = [
        _P, ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _P, _P, _P, ctypes.c_int, _P]
    lib.project_and_bin.restype = ctypes.c_int
    for name in ("project_and_bin_max_m", "project_and_bin_max_smem"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if lib.project_and_bin_max_m() != MAX_M:
        raise RuntimeError("kernel's largest m differs from MAX_M")
    return lib


def project_and_bin(x: torch.Tensor, z: torch.Tensor, w: float, c: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA kernel K5 — see ``kernels.ref.project_and_bin``. x (N, d):
    contiguous fp32 or bf16 on a CUDA device; z (m, d) on the same device,
    1 <= m <= :data:`MAX_M` (upcast to fp32 once, as the TPU kernel does on
    load). Returns (h1, h2, p), each (N, m): int32, int32, fp32."""
    if x.device.type != "cuda" or z.device != x.device:
        raise ValueError(f"x and z must be on one CUDA device, got "
                         f"{x.device} and {z.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, d) tensor, got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    if z.dim() != 2 or z.shape[1] != d or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (m, {d}) tensor, got "
                         f"{tuple(z.shape)}")
    m = z.shape[0]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m={m} projections not supported (kernel takes "
                         f"1..{MAX_M})")
    if d < 1:
        raise ValueError("x must have at least one feature")
    lib = library()
    if m * d * 4 > lib.project_and_bin_max_smem():
        raise ValueError(f"z of {m} x {d} does not fit in shared memory")
    inv_w, half_w, cf = bin_constants(w, c)
    z32 = z.to(torch.float32).contiguous()
    h1 = torch.empty((n, m), dtype=torch.int32, device=x.device)
    h2 = torch.empty((n, m), dtype=torch.int32, device=x.device)
    p = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            sms = torch.cuda.get_device_properties(x.device) \
                .multi_processor_count
            err = lib.project_and_bin(
                x.data_ptr(), int(x.dtype == torch.bfloat16), z32.data_ptr(),
                n, d, m, inv_w, half_w, cf, h1.data_ptr(), h2.data_ptr(),
                p.data_ptr(), sms,
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"project_and_bin: kernel launch failed with "
                               f"CUDA error {err}")
        build.count(launches, "project_and_bin")
    return h1, h2, p
