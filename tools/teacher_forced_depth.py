"""How far teacher-forced decode drifts from the forward as layers are added,
in the reference package and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/teacher_forced_depth.py \
        [--arch mamba2-2.7b] [--width 256] [--depths 4 16 64]

For each depth the architecture's ``smoke()`` config is widened to
``--width`` and deepened to that many layers; both packages run the same
parameters (the reference's, carried) on the same seeded tokens: the
forward over 24 tokens, and prefill on 16 then 8 decode steps of the given
tokens. Printed per depth: max |decode - forward| over the forward's largest
logit for the reference and for the port, and the port's forward against
the reference's. The two paths round differently (the whole-sequence
attention or SSD against the one-token direct path and recurrence), and the
difference compounds layer after layer; ``chip_smoke.py``'s ``[generate]``
holds full-depth models to a bound that grows as the square root of depth.
Like the tests, this script imports both packages.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as rt
from repro.models.api import model_api as ref_model_api
from repro_torch.configs import get_config
from repro_torch.core.carry import model_params_from_numpy
from repro_torch.models import transformer as tt
from repro_torch.models.api import model_api


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def drift(arch: str, layers: int, width: int, s: int = 24, p: int = 16):
    def cut(c):
        c = c.smoke()
        return dataclasses.replace(c, n_layers=layers, d_model=width,
                                   d_ff=2 * width if c.d_ff else 0)
    rcfg, cfg = cut(ref_get_config(arch)), cut(get_config(arch))
    rparams = ref_model_api(rcfg).init(jax.random.PRNGKey(0))
    tparams = model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, s))
    rapi, api = ref_model_api(rcfg), model_api(cfg)
    jt = jnp.asarray(toks, jnp.int32)
    full, _ = rt.forward_train(rparams, rcfg, jt, remat=False)
    lg, cache = rapi.prefill(rparams, {"tokens": jt[:, :p]}, max_seq=s)
    got = [lg]
    for i in range(p, s):
        lg, cache = rapi.decode(rparams, cache, jt[:, i:i + 1])
        got.append(lg)
    ref_drift = rel(jnp.stack(got, 1).astype(jnp.float32),
                    full[:, p - 1:].astype(jnp.float32))
    tt_toks = torch.from_numpy(toks)
    with torch.inference_mode():
        tfull, _ = tt.forward_train(tparams, cfg, tt_toks)
        lg, cache = api.prefill(tparams, {"tokens": tt_toks[:, :p]},
                                max_seq=s)
        got = [lg]
        for i in range(p, s):
            lg, cache = api.decode(tparams, cache, tt_toks[:, i:i + 1])
            got.append(lg)
    port_drift = rel(torch.stack(got, 1).float().numpy(),
                     tfull[:, p - 1:].float().numpy())
    cross = rel(tfull.float().numpy(), full.astype(jnp.float32))
    return ref_drift, port_drift, cross


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 16, 64])
    args = ap.parse_args()
    torch.set_num_threads(4)
    for layers in args.depths:
        ref_drift, port_drift, cross = drift(args.arch, layers, args.width)
        print(f"{args.arch} width {args.width} depth {layers}: teacher-forced "
              f"drift reference {ref_drift:.4f}, port {port_drift:.4f}; port "
              f"forward vs reference forward {cross:.4f}", flush=True)


if __name__ == "__main__":
    main()
