"""prefill.mfu_pct.batch: prefill model FLOPs over device-busy seconds at the bf16 peak (%); moves tokens_per_s."""
from geoffbench.readers import prefill_mfu_pct as read  # noqa: F401
