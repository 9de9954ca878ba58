"""tokens_per_s: prompt positions completed in the window per second; the closed-loop cell."""
from geoffbench.readers import tokens_per_s as read  # noqa: F401
