"""device.idle_pct.batch: share of the traced window with the card idle (%); moves tokens_per_s."""
from geoffbench.readers import device_idle_pct as read  # noqa: F401
