"""The paper's own experimental configuration (§VIII) as a config module —
index hyper-parameters and the dataset grid used by the benchmarks."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PromishConfig:
    m: int = 2                 # random unit vectors per HI structure
    n_scales: int = 5          # L (paper: L=5, w0 = pMax / 2^L)
    buckets_per_point: float = 1.0
    seed: int = 0


PAPER_DEFAULT = PromishConfig()

# Table III — the paper's real-dataset grid (sizes, dictionary, tags/point).
PAPER_REAL_DATASETS = (
    dict(n=10_000, u=5_661, t=12),
    dict(n=30_000, u=6_753, t=13),
    dict(n=50_000, u=7_101, t=13),
    dict(n=70_000, u=7_902, t=14),
    dict(n=1_000_000, u=24_874, t=11),
)

# §VIII synthetic defaults
PAPER_SYNTH = dict(coord_range=10_000.0, u=1_000, t=1)
