"""setup_s: process start to the window's start (s)."""
from geoffbench.readers import setup_s as read  # noqa: F401
