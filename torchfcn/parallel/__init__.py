from torchfcn.parallel.distributed import (  # noqa: F401
    LocalBatch, all_gather_cat, initialize_distributed, run_ranks,
    shard_batch, shard_params_replicated, shutdown_distributed, split_rows)
