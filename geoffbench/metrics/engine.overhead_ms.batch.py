"""engine.overhead_ms.batch: workflow engine's own ms a request; moves tokens_per_s."""
from geoffbench.readers import engine_overhead_ms as read  # noqa: F401
