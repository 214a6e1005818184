"""Multi-GPU fits: row-sharded data parallelism over ``torch.distributed``, one rank per GPU."""
