"""The port's attention (K7's plain version) against the reference package.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs
``kernels.ref.flash_attention``, the plain PyTorch version of the CUDA kernel
K7. The reference's Pallas kernel does not run on this tree (its tests fail
on a removed Pallas API), so the port is held against the kernel's own
references on the same seeded numpy inputs:

  * in fp32, against ``kernels.ref.flash_attention_ref`` (the dense-softmax
    oracle) over the five shapes of the reference's flash-attention tests
    plus grouped-query cases. Both are fp32 softmax attention; they differ
    only in where the 1/sqrt(hd) scale enters (before the dot here, after it
    there) and in summation order, so they agree to 1e-5;
  * in bf16, against ``models.common.blockwise_attention``, the model's own
    attention path on the CPU. The port rounds q*scale and the softmax
    numerators to bf16 where the kernel does; the reference scales fp32
    scores and rounds normalised probabilities. Each rounding is a relative
    2^-9, so the outputs (averages of v, |v| <= ~4.5) agree to two bf16
    ulps of the output plus 2^-8 of max|v|.

The backward (K7b's plain version, ``kernels.ref.flash_attention_bwd``) is
held, on the cases of the issue's grid (causal, window and non-causal; GQA
4/2 and 4/1; hd 16, 64 and 128; S = 1, 33 and 130):

  * in fp32, against autograd of a dense fp32 softmax attention: nothing
    rounds, so they agree to 1e-5 of the largest of the three gradients
    (at S = 1 the exact dq and dk are 0, and both give fp32 noise);
  * in bf16, against ``jax.vjp`` of the reference's
    ``models.common.blockwise_attention`` (the gradient the reference's
    training takes on the CPU, XLA autodiff of its direct path): within
    2^-6 of the largest of the three reference gradients. The two round at
    different places: the reference rounds the normalised probabilities and
    the probabilities' cotangent dP to bf16, the port the unnormalised
    numerators P and dS; each rounding is a relative 2^-9 and each output
    is rounded to bf16 once (the largest difference on the grid is 0.0065
    of the scale);
  * through ``ops.flash_attention`` under autograd (the
    ``torch.autograd.Function`` whose CPU route is the plain forward and
    backward): its gradients equal the plain backward's bit for bit, and
    ``torch.autograd.gradcheck`` passes in fp64 on a tiny case.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
holds them against these plain versions there, and ``chip_smoke.py`` at the
main paths' shapes.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels.ref import flash_attention_ref
from repro.models.common import blockwise_attention
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# (B, S, H, Kv, hd, causal, window): the reference's five flash shapes with
# B=2, then grouped-query heads (the kernel reads kv head h // (H/Kv)).
CASES = [
    (2, 64, 2, 2, 16, True, None),
    (2, 128, 1, 1, 32, True, None),
    (2, 96, 2, 2, 16, False, None),
    (2, 64, 2, 2, 16, True, 32),
    (2, 72, 3, 3, 8, True, None),
    (2, 80, 6, 2, 16, True, None),
    (1, 70, 4, 1, 64, True, 24),
]


def _qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_plain_flash_matches_dense_reference_fp32(b, s, h, kv, hd, causal,
                                                  window):
    q, k, v = _qkv(b, s, h, kv, hd, seed=s + h)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    g = h // kv
    want = flash_attention_ref(jnp.asarray(q),
                               jnp.asarray(np.repeat(k, g, axis=2)),
                               jnp.asarray(np.repeat(v, g, axis=2)),
                               causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_plain_flash_matches_model_attention_bf16(b, s, h, kv, hd, causal,
                                                  window):
    q, k, v = _qkv(b, s, h, kv, hd, seed=7 * s + hd)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*bf, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want = blockwise_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)),
                               pos, pos, causal=causal, window=window)
    want = np.asarray(want.astype(jnp.float32))
    vmax = float(np.abs(bf[2].float().numpy()).max())
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2 * 2.0 ** -8 * np.abs(want) + 2.0 ** -8 * vmax).all(), \
        float(err.max())


def _online_softmax(q, k, v, causal, window, skip=None, tile=64):
    """The kernel's arithmetic, written out on the CPU: fp32 scores of the
    bf16-rounded q*scale, an online softmax over key tiles of ``tile`` with
    the numerators rounded to bf16 at the running maximum, fp32 accumulators
    and denominator, bf16 output. ``skip=(rows, keys)`` plants a fault: the
    query rows ``rows`` never see the key tile starting at ``keys``."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qs = (q.float() * hd ** -0.5).to(q.dtype).float()
    kf = k.repeat_interleave(g, dim=2).float()
    vf = v.repeat_interleave(g, dim=2).float()
    sc = torch.einsum("bshd,bthd->bhst", qs, kf)
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    valid = torch.ones((s, s), dtype=torch.bool)
    if causal:
        valid &= j <= i
    if window is not None:
        valid &= j > i - window
    sc = sc.masked_fill(~valid, -1e30)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    for t0 in range(0, s, tile):
        st = sc[..., t0:t0 + tile]
        if skip is not None and t0 == skip[1]:
            st = st.clone()
            st[:, :, skip[0]] = -1e30
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pt = torch.exp(st - m_new)
        l = l * alpha + pt.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhst,bthd->bhsd", pt.to(v.dtype).float(), vf[:, t0:t0 + tile])
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window",
                         [(1, 320, 2, 2, 64, True, None),
                          (2, 256, 4, 1, 128, True, None),
                          (1, 300, 3, 3, 64, True, 100),
                          (1, 200, 2, 1, 64, False, None)])
def test_flash_tolerance_admits_running_max_and_rejects_dropped_tile(
        b, s, h, kv, hd, causal, window):
    """``ref.flash_attention_tolerance``, the bound the card holds K7 to,
    admits the kernel's own rounding (numerators at the running maximum)
    and rejects a kernel that drops the key tile [64, 128) for the query
    rows from 128 on, which see it."""
    from repro_torch.kernels import ref
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(b, s, h, kv, hd, seed=3 * s + hd))
    plain = ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = ref.flash_attention_tolerance(q, k, v, plain, causal=causal,
                                        window=window)
    ok = _online_softmax(q, k, v, causal, window)
    err = (ok.float() - plain.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    bad = _online_softmax(q, k, v, causal, window, skip=(slice(128, s), 64))
    assert float(((bad.float() - plain.float()).abs() / tol).max()) > 1.0


def test_kernel_wrapper_takes_cuda_bf16_only():
    """The kernel's wrapper never runs the plain version: a CPU tensor, a
    non-bf16 dtype or an unsupported head dim raises before any launch."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash.flash_attention(q, q, q)
    assert cuda_flash.launches["flash_attention"] == 0
    assert set(cuda_flash.HEAD_DIMS) == {64, 128}


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window",
                         [(1, 384, 2, 2, 64, True, None),
                          (2, 320, 4, 1, 128, True, None),
                          (1, 400, 3, 3, 64, True, 200),
                          (1, 300, 2, 1, 64, False, None)])
def test_flash_tolerance_at_128_key_tiles(b, s, h, kv, hd, causal, window):
    """The tolerance does not depend on the kernel's key tile: the online
    softmax over tiles of 128 keys stays within it, and dropping the key
    tile [128, 256) for the query rows from 256 on, which see it, does
    not."""
    from repro_torch.kernels import ref
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(b, s, h, kv, hd, seed=5 * s + hd))
    plain = ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = ref.flash_attention_tolerance(q, k, v, plain, causal=causal,
                                        window=window)
    ok = _online_softmax(q, k, v, causal, window, tile=128)
    err = (ok.float() - plain.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    bad = _online_softmax(q, k, v, causal, window, skip=(slice(256, s), 128),
                          tile=128)
    assert float(((bad.float() - plain.float()).abs() / tol).max()) > 1.0


def test_kernel_wrapper_refuses_what_tma_cannot_take():
    """K7 reads q, k and v through TMA tensor maps and copies nothing: a
    base off a 16-byte boundary is refused, and so is a query whose work
    units (64 query rows of one batch and head) outgrow int32."""
    flat = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    cuda_flash.check_tma_operand("q", flat[8:].view(2, 8, 2, 64))
    with pytest.raises(ValueError, match="16-byte boundary"):
        cuda_flash.check_tma_operand("q", flat[1:2 * 8 * 2 * 64 + 1]
                                     .view(2, 8, 2, 64))
    cuda_flash.check_units(32, 512, 36)
    with pytest.raises(ValueError, match="work units"):
        cuda_flash.check_units(1 << 16, 1 << 16, 64)
    assert cuda_flash.launches["flash_attention"] == 0


# (causal, window) x (H, Kv) x hd x S: the backward's grid.
BWD_CASES = list(itertools.product([(True, None), (True, 8), (False, None)],
                                   [(4, 2), (4, 1)], [16, 64, 128],
                                   [1, 33, 130]))


def _bwd_inputs(s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((2, s, h, hd), (2, s, kv, hd), (2, s, kv, hd),
                               (2, s, h, hd)))


def _dense_attention(q, k, v, causal, window):
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kf, vf = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    sc = torch.einsum("bshd,bthd->bhst", q * (1.0 / hd ** 0.5), kf)
    i = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    sc = sc.masked_fill(~mask, -1e30)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), vf)


@pytest.mark.parametrize("mask,heads,hd,s", BWD_CASES)
def test_plain_backward_matches_dense_autograd_fp32(mask, heads, hd, s):
    (causal, window), (h, kv) = mask, heads
    q, k, v, do = (torch.from_numpy(a) for a in
                   _bwd_inputs(s, h, kv, hd, seed=s + hd + h * kv))
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    _dense_attention(*leaves, causal, window).backward(do)
    o, lse = ref.flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    got = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                  window=window)
    scale = max(float(a.grad.abs().max()) for a in leaves)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        assert float((g - leaf.grad).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mask,heads,hd,s", BWD_CASES)
def test_backward_matches_reference_vjp_bf16(mask, heads, hd, s):
    (causal, window), (h, kv) = mask, heads
    q, k, v, do = _bwd_inputs(s, h, kv, hd, seed=7 * s + hd + h * kv)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (2, s))
    _, vjp = jax.vjp(lambda a, b, c: blockwise_attention(
        a, b, c, pos, pos, causal=causal, window=window),
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, jnp.bfloat16))]
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    scale = max(float(np.abs(w).max()) for w in want)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        err = float(np.abs(leaf.grad.float().numpy() - w).max())
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_autograd_function_routes_cpu_to_plain_backward():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in
                   _bwd_inputs(70, 8, 2, 64, seed=5))
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=24)
    assert out.grad_fn is not None
    out.backward(do)
    o, lse = ref.flash_attention(q, k, v, causal=True, window=24,
                                 return_lse=True)
    assert torch.equal(out.detach(), o)
    want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                   window=24)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        assert ops.flash_attention(*leaves, causal=True).grad_fn is None


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
def test_autograd_function_gradcheck_fp64(causal, window):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((1, 6, 4, 8), (1, 6, 2, 8), (1, 6, 2, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal,
                                            window=window), (q, k, v))


def test_backward_wrapper_takes_cuda_bf16_only():
    x = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash.flash_attention_bwd(x, x, x, x, x, lse)
