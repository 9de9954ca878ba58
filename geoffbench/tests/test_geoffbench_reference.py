"""The plain reference against the port at a smoke size on the CPU, and
the control's rounding against the program's."""
import pytest
import torch

from geoffbench import check, reference, traffic, weights

from conftest import SMALL


def _arch(name, compute_dtype):
    from geoffbench import spec
    bench = spec.load_benchmark()
    arch = dict(spec.config(bench, name)["port"], **SMALL, compute_dtype=compute_dtype)
    if arch["num_patches"]:
        arch["num_patches"] = 8
    return arch


def _program_logits(arch, params, inp):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import model as M
    cfg = ArchConfig(**dict(arch, block_pattern=tuple(arch["block_pattern"])))
    batch = {"tokens": inp["tokens"][None]}
    if inp.get("patches") is not None:
        batch["patches"] = inp["patches"][None]
    with torch.no_grad():
        logits, _ = M.prefill(cfg, params, batch)
    return logits[0]


def _inputs(arch, seed, lengths):
    out = []
    for i, n in enumerate(lengths):
        r = traffic.Request(i, n, arch["num_patches"], 0.0)
        inp = {"tokens": traffic.text_tokens(seed, r, arch["vocab_size"])}
        if r.patches:
            inp["patches"] = traffic.page_patches(seed, r, arch["d_model"], "cpu")
        out.append(inp)
    return out


@pytest.mark.parametrize("config", ["qwen3-32b", "llava-next-34b"])
def test_reference_agrees_with_the_port_in_float32(config):
    arch = _arch(config, "float32")
    params = weights.make(arch, 7, "cpu")
    inputs = _inputs(arch, 7, [5, 37, 64])
    ref = reference.last_logits(arch, params, inputs, "float32", 1e-6)
    for inp, r in zip(inputs, ref):
        got = _program_logits(arch, params, inp)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, r, rtol=2e-5, atol=2e-5 * float(r.abs().max()))


@pytest.mark.parametrize("config", ["qwen3-32b", "llava-next-34b"])
def test_the_control_reads_far_above_the_program(config):
    """bf16 (the program as configured) against fp8 (the control), both
    against the float32 reference on the same inputs: the control's worst
    logit error is at least three times the program's."""
    arch = _arch(config, "bfloat16")
    params = weights.make(arch, 11, "cpu")
    inputs = _inputs(arch, 11, [9, 40, 64, 17])
    ref = reference.last_logits(arch, params, inputs, "float32", 1e-6)
    got = [_program_logits(arch, params, inp) for inp in inputs]
    prog = check.compared([int(g.argmax()) for g in got], got, ref)
    low = reference.last_logits(arch, params, inputs, "fp8", 1e-6)
    ctrl = check.compared([int(x.argmax()) for x in low], low, ref)
    assert prog["label_not_argmax"] == 0
    assert ctrl["logits_rel_err"] > 3 * prog["logits_rel_err"]


def test_weights_layout_is_the_ports():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import model as M
    from repro_torch.models.tree import tree_map_with_path
    for config in ("qwen3-32b", "llava-next-34b"):
        arch = _arch(config, "bfloat16")
        want = {}
        tree_map_with_path(lambda p, d: want.__setitem__(p, tuple(d.shape)),
                           M.param_defs(ArchConfig(**dict(
                               arch, block_pattern=tuple(arch["block_pattern"])))),
                           is_leaf=lambda x: hasattr(x, "axes"))
        got = {"".join(f"['{k}']" for k in p.split("/")): tuple(s)
               for p, (s, _) in weights.layout(arch).items()}
        assert got == want
    # the full sizes hold the serving bytes the port reports (PERF.md §5)
    from geoffbench import spec
    bench = spec.load_benchmark()
    full = {c: weights.nbytes(spec.config(bench, c)["port"]) / 1e9
            for c in ("qwen3-32b", "llava-next-34b")}
    assert full["qwen3-32b"] == pytest.approx(65.52, abs=0.01)
    assert full["llava-next-34b"] == pytest.approx(68.88, abs=0.01)
