"""End-to-end on the PyTorch/CUDA port: train a ~100M-parameter LM embedder
with checkpoints, then index its embeddings with ProMiSH and answer NKS
queries.

    PYTHONPATH=src python examples/torch/train_embedder.py              # card
    PYTHONPATH=src python examples/torch/train_embedder.py --device cpu
    PYTHONPATH=src python examples/torch/train_embedder.py --steps 300  # full

The whole stack in one script: config -> model (fp32 master parameters) ->
WSD AdamW -> fault-tolerant loop with checkpoints -> ProMiSH ingestion ->
NKS serving. Under 100 steps it trains the config's ``smoke()`` reduction,
as the reference's example does. On the card every self-attention runs
forward through K7 and backward through K7b.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.train import trainer
from repro_torch.models.api import count_params, model_api
from repro_torch.serve.engine import NKSEngine
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_loop import LoopConfig, TrainLoop

# ~100M-param llama-style config (12L x 768, vocab 32k)
EMBEDDER = ArchConfig(
    name="embedder-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000, head_dim=64,
    mlp="swiglu", norm="rmsnorm", schedule="wsd", tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = EMBEDDER if args.steps >= 100 else EMBEDDER.smoke()
    api = model_api(cfg)
    print(f"model: {cfg.name}  params={count_params(cfg) / 1e6:.1f}M  "
          f"device={device}")

    opt_cfg = OptimizerConfig(peak_lr=3e-4,
                              warmup_steps=max(args.steps // 10, 2),
                              total_steps=args.steps, schedule="wsd")
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        global_batch=args.batch,
                                        seq_len=args.seq, seed=0))
    init_state, stepper = trainer(cfg, opt_cfg, device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="embedder-ckpt-")
    loop = TrainLoop(LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                                ckpt_every=max(args.steps // 3, 2)),
                     stepper, pipe, init_state)
    state, hist = loop.run()
    print(f"trained {len(hist)} steps: loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f} (ckpts in {ckpt_dir})")

    # ---- embed a corpus and serve NKS queries over it ----------------------
    rng = np.random.default_rng(1)
    n_docs, n_tags = 48, 10
    batches, keywords = [], []
    for _ in range(0, n_docs, 8):
        toks = rng.integers(0, cfg.vocab_size, (8, args.seq))
        batches.append({"tokens": torch.as_tensor(toks, dtype=torch.long)})
        keywords.extend(sorted(rng.choice(n_tags, size=2,
                                          replace=False).tolist())
                        for _ in range(8))
    engine = NKSEngine.ingest_embeddings(api, state["params"], batches,
                                         keywords, n_scales=4, device=device)
    query = [0, 1]
    res = engine.query(query, k=1, tier="exact")
    print(f"NKS query {query} -> ids={res.candidates[0].ids} "
          f"diameter={res.candidates[0].diameter:.3f} "
          f"({res.latency_s * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
