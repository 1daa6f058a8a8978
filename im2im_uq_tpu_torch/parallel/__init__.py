"""Data parallelism over processes, one per GPU (``torch.distributed``)."""
