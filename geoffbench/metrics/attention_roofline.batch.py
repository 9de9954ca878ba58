"""attention_roofline.batch: attention's bound over its kernels' device time (%); moves tokens_per_s."""
from geoffbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "attention")
