"""Draws the frozen query log of a tag-log mix, once, into its mix file.

    python3 nksbench/draw_log.py CONFIG MIX [--queries 256] [--q 3]

Takes ``--queries`` points uniformly (numpy's ``default_rng(0)``, without
replacement) from the configuration's seed-0 corpus and, for each, ``--q``
of its tags drawn without replacement, sorted, as
``benchmarks/fig9_size.py`` samples queries from real tag sets: tags that
co-occur on a point, the most popular first (a tag id is its popularity
rank, and the first is the anchor). fig9 takes a point's first ``--q``
tags instead; on this generator 67% of the points carry tag 0, which
would make it the anchor of most queries and a query's work about 3.6e13
operations, half a second at the card's peak. Only the tags are made, on
the host, so no card is needed. Writes the log into the mix file's
``query.log``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def draw(config: dict, queries: int, q: int) -> list[list[int]]:
    from harness.corpus import make_corpus

    corpus = make_corpus(config, seed=0)
    rng = np.random.default_rng(0)
    picks = rng.choice(corpus.n, size=queries, replace=False)
    return [sorted(rng.choice(corpus.tags_of(int(i)), size=q,
                              replace=False).tolist()) for i in picks]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("mix")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--q", type=int, default=3)
    args = ap.parse_args()
    config = json.loads(pathlib.Path(args.config).read_text())
    mix_path = pathlib.Path(args.mix)
    mix = json.loads(mix_path.read_text())
    mix["query"]["log"] = draw(config, args.queries, args.q)
    text = json.dumps(mix, indent=2)
    # one query a line
    for row in mix["query"]["log"]:
        text = text.replace(json.dumps(row, indent=2).replace("\n", "\n      "),
                            json.dumps(row), 1)
    mix_path.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
