"""Wrappers of the CUDA threshold-join kernels (``csrc/pairwise_l2.cu``).

The library builds at the first call (``kernels.build``) and binds through
``ctypes``. Every wrapper checks device, dtype, shape and contiguity,
allocates its outputs, launches on the current stream, raises on a launch
error, and adds one to its entry of :data:`launches` for each launch — the
count a run reads to show that its path went through the kernel (K1, K2 and
K2i also add one to ``<name>_elig`` for a launch given eligibility words).
There is no fallback: these take CUDA tensors only (``kernels.ops`` routes
CPU tensors to the plain versions in ``kernels.ref``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import JOIN_SQUARE_TILE

# Launches per kernel since the last reset_launches().
launches = {"join_batched_masked": 0, "join_batched_prune": 0,
            "join_batched_prune_int8": 0,
            "pairwise_join": 0, "join_batched_tiles": 0,
            "join_batched_masked_elig": 0, "join_batched_prune_elig": 0,
            "join_batched_prune_int8_elig": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    build.reset(launches)


def library() -> ctypes.CDLL:
    """The built and bound kernel library (built on first use)."""
    return build.load("pairwise_l2", _bind)


def _bind() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build("pairwise_l2")))
    lib.join_batched_masked.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P,
                                        _P, _P, _P]
    lib.join_batched_prune.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P,
                                       _P]
    lib.join_batched_prune_int8.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _P, _P, _P, _P, _P]
    lib.pairwise_join.argtypes = [_P, _P, _I, _I, _I, ctypes.c_float, _I,
                                  _I, _P, _P, _P]
    lib.join_batched_tiles.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                       _P, _P, _P]
    for fn in (lib.join_batched_masked, lib.join_batched_prune,
               lib.join_batched_prune_int8, lib.pairwise_join,
               lib.join_batched_tiles, lib.join_square_tile):
        fn.restype = _I
    lib.join_square_tile.argtypes = []
    if lib.join_square_tile() != JOIN_SQUARE_TILE:
        raise RuntimeError("the kernels' square tile differs from "
                           "kernels.ref's JOIN_SQUARE_TILE")
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launched(name: str, err: int, elig: torch.Tensor | None = None,
              kernels: int = 1) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    build.count(launches, name, kernels)
    if elig is not None:
        build.count(launches, name + "_elig", kernels)


_MAX_INT32 = 2 ** 31 - 1


def check_triangle_tiles(p: int) -> None:
    """K1 and K2 number the tiles (ti <= tj) of the upper triangle of
    :data:`JOIN_SQUARE_TILE` tiles of a subset in int32; raises where P
    makes more."""
    t = -(-p // JOIN_SQUARE_TILE)
    if t * (t + 1) // 2 > _MAX_INT32:
        raise ValueError(f"P={p} makes more triangle tiles than the kernel "
                         f"numbers ({t} tiles a side)")


def _check_batched(x, lengths, r, elig=None):
    if x.dim() != 3:
        raise ValueError(f"x must be (S, P, d), got {tuple(x.shape)}")
    s, p, d = x.shape
    _check(x, "x", torch.float32, (s, p, d), x.device)
    _check(lengths, "lengths", torch.int32, (s,), x.device)
    _check(r, "r", torch.float32, (s,), x.device)
    if elig is not None:
        _check(elig, "elig", torch.int32, (s, (p + 31) // 32), x.device)
    return s, p, d


def join_batched_masked(x: torch.Tensor, lengths: torch.Tensor,
                        r: torch.Tensor, elig: torch.Tensor | None = None, *,
                        with_sq: bool = False):
    """CUDA kernel K1 — see ``kernels.ref.join_batched_masked``. The kernel
    writes every mask word (the tiles past a subset's length write zeros)
    but only the live tiles of sq (with ``with_sq``), which starts at
    fp32-max."""
    s, p, d = _check_batched(x, lengths, r, elig)
    check_triangle_tiles(p)
    dev = x.device
    mask = torch.empty((s, p, (p + 31) // 32), dtype=torch.int32, device=dev)
    counts = torch.zeros(s, dtype=torch.int32, device=dev)
    sq = torch.full((s, p, p), torch.finfo(torch.float32).max,
                    dtype=torch.float32, device=dev) if with_sq else None
    if s and p and d:
        with torch.cuda.device(dev):
            err = library().join_batched_masked(
                _ptr(x), _ptr(lengths), _ptr(r), _ptr(elig), s, p, d,
                _ptr(mask), _ptr(counts), _ptr(sq),
                torch.cuda.current_stream(dev).cuda_stream)
        _launched("join_batched_masked", err, elig)
    elif d == 0:
        raise ValueError("x must have at least one feature")
    return (mask, counts, sq) if with_sq else (mask, counts)


def join_batched_prune(x: torch.Tensor, lengths: torch.Tensor,
                       r: torch.Tensor,
                       elig: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA kernel K2 — see ``kernels.ref.join_batched_counts``. Takes the
    fp32 tile, rounds coordinates to bf16 as it stages them, and sums the
    products on the tensor cores (``wgmma``) in fp32; ``elig`` is K1's packed
    eligibility words. Any base and any d: rows that are not 16-byte
    aligned are loaded by scalar loads inside the kernel."""
    s, p, d = _check_batched(x, lengths, r, elig)
    check_triangle_tiles(p)
    counts = torch.zeros(s, dtype=torch.int32, device=x.device)
    if s and p and d:
        with torch.cuda.device(x.device):
            err = library().join_batched_prune(
                _ptr(x), _ptr(lengths), _ptr(r), _ptr(elig), s, p, d,
                _ptr(counts), torch.cuda.current_stream(x.device).cuda_stream)
        _launched("join_batched_prune", err, elig)
    elif d == 0:
        raise ValueError("x must have at least one feature")
    return counts


# Widest rows K2i takes: its integer distances n_i + n_j - 2 g reach
# 4 d 127^2, which must stay in int32 (as the reference's do).
INT8_MAX_D = (2 ** 31 - 1) // (4 * 127 * 127)
# int8 features of a wgmma k-step: K2i's rows are padded to a multiple.
INT8_K_STEP = 32


def int8_layout(s: int, p: int, d: int) -> tuple[int, int, int]:
    """K2i's scratch for an (s, p, d) input: the int8 rows' pitch (d rounded
    up to a whole ``wgmma`` k-step of 32 bytes, so that every tensor-map
    stride is a multiple of 16 bytes), the norms' row stride (p rounded up to
    4 ints, 16 bytes, for the same reason) and the bytes of the int8 block,
    after which the (s, stride) int32 norms start on a 16-byte boundary."""
    pitch = -(-d // INT8_K_STEP) * INT8_K_STEP
    return pitch, -(-p // 4) * 4, s * p * pitch


def join_batched_prune_int8(x: torch.Tensor, lengths: torch.Tensor,
                            r: torch.Tensor,
                            elig: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA kernel K2i — see ``kernels.ref.join_batched_counts_int8``. One
    call is two launches on the stream, both counted: a cooperative prep
    kernel (each subset's largest magnitude, then the int8 rows with exact
    int32 norms, into one scratch allocation laid out by
    :func:`int8_layout`) and the join (TMA into ``wgmma`` s8 x s8 -> s32)
    over K2's triangle walk of 128 x 128 tiles. ``elig`` is K1's packed
    eligibility words. The counts are a view of one zeroed int32 buffer
    that also holds the subsets' largest magnitudes."""
    s, p, d = _check_batched(x, lengths, r, elig)
    check_triangle_tiles(p)
    if d > INT8_MAX_D:
        raise ValueError(f"d={d} overflows K2i's int32 distances "
                         f"(at most {INT8_MAX_D} features)")
    if s * p > _MAX_INT32:
        raise ValueError(f"K2i numbers the S P = {s * p} rows in int32")
    dev = x.device
    zeroed = torch.zeros(2 * s, dtype=torch.int32, device=dev)
    counts, maxbits = zeroed[:s], zeroed[s:]
    if s and p and d:
        pitch, pn, q_bytes = int8_layout(s, p, d)
        scratch = torch.empty(q_bytes + s * pn * 4, dtype=torch.uint8,
                              device=dev)
        with torch.cuda.device(dev):
            err = library().join_batched_prune_int8(
                _ptr(x), _ptr(lengths), _ptr(r), _ptr(elig), s, p, d, pitch,
                pn, _ptr(scratch), _ptr(scratch) + q_bytes, _ptr(maxbits),
                _ptr(counts), torch.cuda.current_stream(dev).cuda_stream)
        if err < 0:
            raise RuntimeError(f"join_batched_prune_int8: TMA tensor map "
                               f"encoding failed (CUresult {-err})")
        _launched("join_batched_prune_int8", err, elig, kernels=2)
    elif d == 0:
        raise ValueError("x must have at least one feature")
    return counts


def _check_grid(bm: int, bn: int) -> None:
    if bm < 1 or bn < 1:
        raise ValueError(f"tile sizes must be positive, got ({bm}, {bn})")


def join_batched_tiles(x: torch.Tensor, lengths: torch.Tensor,
                       r: torch.Tensor, *, bm: int = 128, bn: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel K4 — see ``kernels.ref.join_batched_dense``. Returns sq
    (S, P, P) fp32 and counts (S, ceil(P/bm), ceil(P/bn)) int32. One launch
    writes every cell: the live squares (the upper triangle of 128 x 128
    tiles, mirrored) and fp32-max elsewhere."""
    s, p, d = _check_batched(x, lengths, r)
    _check_grid(bm, bn)
    sq = torch.empty((s, p, p), dtype=torch.float32, device=x.device)
    counts = torch.zeros((s, -(-p // bm), -(-p // bn)), dtype=torch.int32,
                         device=x.device)
    if s and p and d:
        with torch.cuda.device(x.device):
            err = library().join_batched_tiles(
                _ptr(x), _ptr(lengths), _ptr(r), s, p, d, bm, bn, _ptr(sq),
                _ptr(counts), torch.cuda.current_stream(x.device).cuda_stream)
        _launched("join_batched_tiles", err)
    elif d == 0:
        raise ValueError("x must have at least one feature")
    return sq, counts


def pairwise_join(a: torch.Tensor, b: torch.Tensor,
                  r: float = float("inf"), *, bm: int = 128, bn: int = 128
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel K3 — see ``kernels.ref.pairwise_join``. Returns sq (M, N)
    fp32 and counts (ceil(M/bm), ceil(N/bn)) int32."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a (M, d) and b (N, d) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (m, d), n = a.shape, b.shape[0]
    _check(a, "a", torch.float32, (m, d), a.device)
    _check(b, "b", torch.float32, (n, d), a.device)
    _check_grid(bm, bn)
    sq = torch.empty((m, n), dtype=torch.float32, device=a.device)
    counts = torch.zeros((-(-m // bm), -(-n // bn)), dtype=torch.int32,
                         device=a.device)
    if m and n and d:
        with torch.cuda.device(a.device):
            err = library().pairwise_join(
                _ptr(a), _ptr(b), m, n, d, float(r), bm, bn, _ptr(sq),
                _ptr(counts), torch.cuda.current_stream(a.device).cuda_stream)
        _launched("pairwise_join", err)
    elif d == 0:
        raise ValueError("a and b must have at least one feature")
    return sq, counts
