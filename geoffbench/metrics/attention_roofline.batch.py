"""attention_roofline.batch: attention's bound over its kernels' device time (%); moves tokens_per_s."""
from geoffbench.readers import attention_roofline_pct as read  # noqa: F401
