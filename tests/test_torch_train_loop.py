"""The port's checkpoints (across packages), its fault-tolerant loop and
its launcher, on the CPU.

Checkpoints written by either package from the same state (a smoke model's
fp32 master parameters and AdamW state, fp32 or bf16 moments) have equal
manifests (shape, dtype, sha256 of each leaf) and load in the other leaf
for leaf equal; the port restores a bf16 state whichever package wrote it,
and the reference's own loader is pinned failing on it. The loop runs the
reference's ``test_train_loop_end_to_end`` scenario and a preemption; the
launcher ``--smoke --device cpu`` trains, checkpoints and resumes.
"""
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as rck
from repro_torch.ckpt.checkpoint import (CheckpointManager, find_latest,
                                         load_checkpoint, save_checkpoint)
from repro_torch.core.carry import model_params_from_numpy, opt_state_from_numpy
from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as train_launch
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import LoopConfig, TrainLoop
from test_torch_train import _tree_and_grads

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- checkpoints
def _train_state(seed: int, state_dtype: str):
    """A smoke model's state in both layouts: the reference's (numpy, for
    ``repro.ckpt``) and the port's."""
    cfg, tree, grads, m, v = _tree_and_grads(seed)
    rdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    ref_state = {"params": jax.tree.map(jnp.asarray, tree),
                 "opt": {"m": jax.tree.map(lambda a: jnp.asarray(a, rdt), m),
                         "v": jax.tree.map(lambda a: jnp.asarray(a, rdt), v),
                         "step": jnp.asarray(5, jnp.int32)}}
    port_state = {
        "params": model_params_from_numpy(cfg, tree, device="cpu",
                                          master=True),
        "opt": opt_state_from_numpy(cfg, jax.tree.map(np.asarray,
                                                      ref_state["opt"]),
                                    device="cpu")}
    return cfg, ref_state, port_state


def _port_equal(got, want):
    a, b = topt.tree_leaves(got), topt.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_fp32_checkpoints_load_across_packages(tmp_path):
    cfg, ref_state, port_state = _train_state(seed=4, state_dtype="float32")
    ref_path = rck.save_checkpoint(str(tmp_path / "ref"), 7, ref_state,
                                   extra={"next_step": 7})
    port_path = save_checkpoint(str(tmp_path / "port"), 7, port_state,
                                extra={"next_step": 7})
    assert _manifest(ref_path) == _manifest(port_path)

    # the reference's file into the port
    _, _, like = _train_state(seed=9, state_dtype="float32")
    got, step, extra = load_checkpoint(ref_path, like)
    assert (step, extra) == (7, {"next_step": 7})
    _port_equal(got, port_state)
    # the port's file into the reference
    _, ref_like, _ = _train_state(seed=9, state_dtype="float32")
    rgot, rstep, rextra = rck.load_checkpoint(port_path, ref_like)
    assert (rstep, rextra) == (7, {"next_step": 7})
    for a, b in zip(jax.tree.leaves(rgot), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_state_checkpoints_restore_in_the_port(tmp_path):
    cfg, ref_state, port_state = _train_state(seed=4, state_dtype="bfloat16")
    ref_path = rck.save_checkpoint(str(tmp_path / "ref"), 3, ref_state)
    port_path = save_checkpoint(str(tmp_path / "port"), 3, port_state)
    assert _manifest(ref_path) == _manifest(port_path)
    meta = _manifest(port_path)["leaves"]
    assert meta["opt/m/embed/tok"]["dtype"] == "bfloat16"
    assert meta["opt/step"]["dtype"] == "int32"
    for path in (ref_path, port_path):
        _, _, like = _train_state(seed=9, state_dtype="bfloat16")
        got, step, _ = load_checkpoint(path, like)
        assert step == 3
        _port_equal(got, port_state)


def test_reference_loader_cannot_restore_bf16_state(tmp_path):
    """The frozen reference's own defect (ROADMAP Queue C): its
    ``save_checkpoint`` writes bf16 leaves as raw 2-byte records, and its
    ``load_checkpoint`` cannot cast them back."""
    _, ref_state, _ = _train_state(seed=4, state_dtype="bfloat16")
    path = rck.save_checkpoint(str(tmp_path), 3, ref_state)
    with pytest.raises(ValueError, match="cast"):
        rck.load_checkpoint(path, ref_state)


def test_checkpoint_verifies_shapes_and_rolls(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "layers": [{"a": torch.ones(2)}, {"a": torch.zeros(2)}],
             "opt": None}
    path = save_checkpoint(str(tmp_path), 4, state)
    assert _manifest(path)["leaves"]["layers/a"]["shape"] == [2, 2]
    got, step, _ = load_checkpoint(path, state)
    assert got["opt"] is None and step == 4
    assert torch.equal(got["layers"][1]["a"], torch.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {**state, "w": torch.zeros(3, 2)})
    # a flipped byte fails the checksum before any state is built
    npz = os.path.join(path, "arrays.npz")
    raw = dict(np.load(npz))
    raw["w"] = raw["w"] + 1
    np.savez(npz, **raw)
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(path, state)
    mgr = CheckpointManager(str(tmp_path / "roll"), keep=2, every=5)
    for s in range(1, 21):
        mgr.maybe_save(s, state)
    assert sorted(os.listdir(tmp_path / "roll")) == ["step_00000015",
                                                     "step_00000020"]
    assert find_latest(str(tmp_path / "roll")).endswith("step_00000020")
    assert not [d for d in os.listdir(tmp_path / "roll")
                if d.startswith(".tmp")]


# -------------------------------------------------------------- train loop
def test_train_loop_end_to_end(tmp_path):
    """The reference's ``test_train_loop_end_to_end`` scenario on the port:
    loss decreases, and a checkpoint resume continues where it stopped."""
    cfg = topt.OptimizerConfig(peak_lr=0.05, warmup_steps=2, total_steps=30,
                               weight_decay=0.0)
    pipe = TokenPipeline(PipelineConfig(vocab_size=50, global_batch=4,
                                        seq_len=8, seed=0))
    rng = np.random.default_rng(0)
    emb0 = rng.standard_normal((50, 16)).astype(np.float32)
    out0 = rng.standard_normal((16, 50)).astype(np.float32)

    def init_state():
        params = {"emb": torch.from_numpy(emb0.copy()),
                  "out": torch.from_numpy(out0.copy())}
        return {"params": params, "opt": topt.init_opt_state(params, cfg)}

    def loss_fn(params, batch):
        x = params["emb"][torch.as_tensor(batch["tokens"]).long()]
        logits = x @ params["out"]
        gold = torch.gather(logits, -1, torch.as_tensor(
            batch["targets"]).long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).mean()

    def step(state, batch):
        params = state["params"]
        leaves = topt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
        params, opt, m = topt.adamw_update(params, grads, state["opt"], cfg)
        return {"params": params, "opt": opt}, {"loss": loss.detach(), **m}

    metrics = tmp_path / "metrics.jsonl"
    loop = TrainLoop(LoopConfig(total_steps=15, ckpt_dir=str(tmp_path / "ck"),
                                ckpt_every=5, log_every=5,
                                metrics_path=str(metrics)),
                     step, pipe, init_state)
    state, hist = loop.run()
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [json.loads(x)["step"] for x in metrics.read_text().splitlines()] \
        == [0, 5, 10]
    loop2 = TrainLoop(LoopConfig(total_steps=30, ckpt_dir=str(tmp_path / "ck"),
                                 ckpt_every=5), step, pipe, init_state)
    state2, hist2 = loop2.run()
    assert hist2[0]["step"] == 15          # resumed, not restarted
    assert hist2[-1]["loss"] < hist[-1]["loss"] + 0.5


def test_train_loop_checkpoints_on_preemption(tmp_path):
    """SIGTERM mid-run: the loop saves at the next step boundary and stops;
    a new loop resumes at the saved step with the same state."""
    pipe = TokenPipeline(PipelineConfig(vocab_size=10, global_batch=2,
                                        seq_len=4))
    seen = []

    def step(state, batch):
        seen.append(int(state["n"]))
        if int(state["n"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"n": state["n"] + 1}, {"loss": torch.tensor(0.0)}

    cfg = LoopConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=100)
    _, hist = TrainLoop(cfg, step, pipe,
                        lambda: {"n": torch.tensor(0)}).run()
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert find_latest(str(tmp_path)).endswith("step_00000003")
    state, hist = TrainLoop(cfg, step, pipe,
                            lambda: {"n": torch.tensor(0)}).run()
    assert hist[0]["step"] == 3 and int(state["n"]) == 10


# ---------------------------------------------------------------- launcher
def test_launcher_smoke_on_the_host(tmp_path):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
            "--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"]
    cfg, state, hist = train_launch.run(train_launch.parser().parse_args(argv))
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert int(state["opt"]["step"]) == 3
    assert state["opt"]["m"]["embed"]["tok"].dtype == torch.float32
    assert find_latest(ck).endswith("step_00000002")
    # resumes at the checkpoint's step, with a longer run
    _, _, hist2 = train_launch.run(train_launch.parser().parse_args(
        argv[:-4] + ["--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2"]))
    assert [h["step"] for h in hist2] == [2, 3]
    # --smoke trains on its 1 x 1 mesh whatever --multi-pod says, as in the
    # reference: the same losses as a run without it
    ck2 = str(tmp_path / "ck2")
    _, _, hist3 = train_launch.run(train_launch.parser().parse_args(
        argv[:-6] + ["--steps", "1", "--ckpt-dir", ck2, "--multi-pod"]))
    assert hist3[0]["loss"] == hist[0]["loss"]


def test_launcher_module_runs(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--smoke", "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("olmoe-1b-7b-smoke: 2 steps, loss ")
