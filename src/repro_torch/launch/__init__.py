"""The JSONL serving launcher (``python -m repro_torch.launch.serve``)."""
