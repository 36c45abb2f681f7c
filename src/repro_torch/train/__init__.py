"""Training: the AdamW optimizer and its schedules, and the fault-tolerant
loop."""
