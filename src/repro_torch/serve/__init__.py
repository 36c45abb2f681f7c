"""The batched serving engine, its write-ahead log and fault plan, and the
serving runtime in front of it."""
