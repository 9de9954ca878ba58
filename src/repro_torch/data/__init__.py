from repro_torch.data.pipeline import (SyntheticCorpus, ShardedLoader,  # noqa: F401
                                       make_train_iterator, shard_batch)
