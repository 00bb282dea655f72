"""Parallelism. So far only `multihost.process_shard`, each process's
slice of a dataset; the multi-card attacks come with their own slice."""
