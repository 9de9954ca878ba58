"""prefetch.exposed_ms.batch: the prefetcher's exposed wait a request (ms); moves tokens_per_s."""
from geoffbench.readers import prefetch_exposed_ms as read  # noqa: F401
