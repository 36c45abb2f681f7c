"""ProMiSH nearest-keyword-set search on PyTorch and CUDA.

The serving path — batched exact and approximate queries over a corpus,
served one batch at a time or as a request stream through the serving
runtime, fed by the document ingest pipeline — with the threshold joins as
hand-written CUDA kernels for Hopper (``kernels/csrc``). Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.

    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    ds = flickr_like_dataset(n=2000, d=16, u=200, t=4, seed=0)
    engine = NKSEngine(ds, device="cpu")
    engine.query_batch(random_queries(ds, 3, 8), tier="exact")
"""
from repro_torch.data.flickr_like import flickr_like_dataset
from repro_torch.data.ingest import (IngestPipeline, JobStore,
                                     ProjectionEmbedder,
                                     flickr_like_documents)
from repro_torch.data.synthetic import random_queries, synthetic_dataset
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

__all__ = ["IngestPipeline", "JobStore", "NKSEngine", "ProjectionEmbedder",
           "RuntimeConfig", "ServingRuntime", "flickr_like_dataset",
           "flickr_like_documents", "random_queries", "synthetic_dataset"]
