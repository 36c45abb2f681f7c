"""The port's multi-device training pieces against the reference's 8-device
runs, on the CPU.

The reference's ``compressed_psum`` and ``pipeline_forward`` run only
inside ``shard_map`` over a real device mesh, so one subprocess forces 8
host devices (``--xla_force_host_platform_device_count=8``, which must be
set before jax starts) and runs them on ``tests/multidev_script.py``'s
inputs, writing inputs and outputs to an ``.npz``. The port runs the same
inputs here on CPU meshes of eight shards. Tolerances, as the reference's
own test: ``compressed_psum`` within 1e-6 relative of the reference's mean
and equal on every shard bit for bit, its error buffer ``g32 - deq``
exactly; ``pipeline_forward`` within 2e-4 relative / 2e-5 absolute of the
reference's last stage, and bit for bit the sequential application of the
same stages.

The reference's sharded flash path cannot run (its Pallas kernel needs a
removed API), so the port's sharded attention is held, as the reference's
own test holds its sharded kernel, against the reference's jnp attention
path on a (data=4, model=2) mesh at 2e-3, and to the port's unsharded
attention bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import blockwise_attention
from repro_torch.launch.mesh import dp_axes, make_local_mesh
from repro_torch.models import hints
from repro_torch.models.common import attend
from repro_torch.train.grad_compress import compressed_psum
from repro_torch.train.pipeline_parallel import (make_pipelined_apply,
                                                 pipeline_forward,
                                                 stage_partition_spec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_local_mesh
    from repro.train.grad_compress import compressed_psum
    from repro.train.pipeline_parallel import pipeline_forward

    mesh = make_local_mesh(data=1, model=1, pod=8)
    # multidev_script.test_compressed_psum's inputs
    rng = np.random.default_rng(0)
    g_all = jnp.asarray(rng.standard_normal((8, 32)), jnp.float32)

    def body(g):
        red, err = compressed_psum({"g": g}, {"g": jnp.zeros_like(g)}, "pod")
        return red["g"], err["g"]

    fn = shard_map(body, mesh=mesh, in_specs=(P("pod", None),),
                   out_specs=(P("pod", None), P("pod", None)),
                   check_rep=False)
    with mesh:
        red, err = fn(g_all)
    # multidev_script.test_pipeline_forward's inputs
    n_stages, m, dim = 8, 16, 32
    rng = np.random.default_rng(2)
    w_all = jnp.asarray(rng.standard_normal((n_stages, dim, dim)) * 0.2,
                        jnp.float32)
    x = jnp.asarray(rng.standard_normal((m, dim)), jnp.float32)

    def pbody(w_local, mb):
        def stage_fn(h, t):
            return jnp.tanh(h @ w_local[0])
        return pipeline_forward(stage_fn, w_local, mb, axis_name="pod")[None]

    pfn = shard_map(pbody, mesh=mesh,
                    in_specs=(P("pod", None, None), P(None, None)),
                    out_specs=P("pod", None, None), check_rep=False)
    with mesh:
        out = pfn(w_all, x)
    np.savez(sys.argv[1], g_all=np.asarray(g_all), red=np.asarray(red),
             err=np.asarray(err), w_all=np.asarray(w_all), x=np.asarray(x),
             pipe=np.asarray(out)[-1])
    print("reference ok")
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("multidev") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def test_compressed_psum_matches_reference(reference):
    g_all = reference["g_all"]
    mesh = make_local_mesh(1, 1, pod=8, device="cpu")
    grads = [{"g": torch.from_numpy(g.copy())} for g in g_all]
    bufs = [{"g": torch.zeros(32)} for _ in range(8)]
    red, err = compressed_psum(grads, bufs, mesh, axis="pod")
    got = np.stack([r["g"].numpy() for r in red])
    np.testing.assert_allclose(got, reference["red"], rtol=1e-6, atol=0)
    assert all(np.array_equal(got[0], row) for row in got)
    np.testing.assert_array_equal(np.stack([e["g"].numpy() for e in err]),
                                  reference["err"])
    # the reference's own bound: within amax / 127 of the exact mean
    assert np.abs(got[0] - g_all.mean(axis=0)).max() \
        <= np.abs(g_all).max() / 127.0 + 1e-6
    with pytest.raises(ValueError, match="participants"):
        compressed_psum(grads[:4], bufs[:4], mesh)


def test_pipeline_forward_matches_reference(reference):
    w_all, x = reference["w_all"], reference["x"]
    mesh = make_local_mesh(1, 1, pod=8, device="cpu")
    ws = [torch.from_numpy(w.copy()) for w in w_all]
    xt = torch.from_numpy(x.copy())
    got = pipeline_forward(lambda w, h: torch.tanh(h @ w), ws, xt,
                           mesh=mesh)
    np.testing.assert_allclose(got.numpy(), reference["pipe"], rtol=2e-4,
                               atol=2e-5)
    seq = []                         # each microbatch through the stages
    for h in xt:
        for w in ws:
            h = torch.tanh(h @ w)
        seq.append(h)
    seq = torch.stack(seq)
    assert torch.equal(got, seq)
    # make_pipelined_apply: 8 layers over 4 stages of 2, on the pod axis
    apply, per = make_pipelined_apply(lambda w, h: torch.tanh(h @ w), 8, 4)
    assert per == 2 and stage_partition_spec() == ("pod",)
    got4 = apply(ws, xt, make_local_mesh(1, 1, pod=4, device="cpu"))
    assert torch.equal(got4, seq)


def test_pipeline_backward_equals_sequential():
    """Autograd through the schedule: the stages' gradients are the
    sequential application's (each stage's microbatch gradients summed in
    the autograd engine's order, within 1e-6 of the largest)."""
    rng = np.random.default_rng(3)
    w0 = [torch.from_numpy((rng.standard_normal((16, 16)) * 0.3)
                           .astype(np.float32)) for _ in range(4)]
    x = torch.from_numpy(rng.standard_normal((6, 3, 16)).astype(np.float32))
    mesh = make_local_mesh(1, 1, pod=4, device="cpu")
    grads = []
    for piped in (True, False):
        ws = [w.clone().requires_grad_(True) for w in w0]
        if piped:
            out = pipeline_forward(lambda w, h: torch.tanh(h @ w), ws, x,
                                   mesh=mesh)
        else:
            out = []
            for h in x:
                for w in ws:
                    h = torch.tanh(h @ w)
                out.append(h)
            out = torch.stack(out)
        (out.square().sum()).backward()
        grads.append([w.grad for w in ws])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_sharded_attention_matches_reference_jnp_path():
    """multidev_script.test_flash_attention_shardmap's shapes: (4, 64, 2,
    16) causal over a (data=4, model=2) mesh, one (row, head) a shard."""
    b, s, h, hd = 4, 64, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
        causal=True, window=None, block=16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = attend(tq, tk, tv, causal=True, window=None)
    mesh = make_local_mesh(4, 2, device="cpu")
    hints.enable_hints_mesh(mesh, dp_axes(mesh), "model")
    try:
        got = attend(tq, tk, tv, causal=True, window=None)
    finally:
        hints.disable_hints()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert torch.equal(got, plain)
