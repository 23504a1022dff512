"""Training on one device (counterpart of ``repro.train``): AdamW with its
schedules and the fault-tolerant trainer."""
