from torchfcn.parallel.distributed import (  # noqa: F401
    LocalBatch, all_gather_bands, all_gather_cat, all_reduce_sum,
    initialize_distributed, run_ranks,
    shard_batch, shard_params_replicated, shutdown_distributed, split_rows)
