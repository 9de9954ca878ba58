"""The plain reference against the port at a smoke size on the CPU, the
control's rounding against the program's, and the dense model module
against what the dense decoder's code gave before it moved into
``models/dense.py`` (``data/dense_parity.json``: every weight's SHA-256,
the reference's and the control's logits, the full layout)."""
import hashlib
import json

import pytest
import torch

from geoffbench import check, spec, traffic, weights

from conftest import DATA, SMALL

PARITY = json.loads((DATA / "dense_parity.json").read_text())


def _arch(name, compute_dtype):
    """(``name``'s port group at the smoke size, its model module)."""
    bench = spec.load_benchmark()
    conf = spec.config(bench, name)
    arch = dict(conf["port"], **SMALL, compute_dtype=compute_dtype)
    if arch["num_patches"]:
        arch["num_patches"] = 8
    return arch, spec.model(conf)


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


def _sha(t):
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("config", ["qwen3-32b", "llava-next-34b"])
def test_reference_agrees_with_the_port_in_float32(config):
    arch, model = _arch(config, "float32")
    params = weights.make(model.layout(arch), 7, "cpu")
    inputs = _inputs(arch, 7, [5, 37, 64])
    ref = model.last_logits(arch, params, inputs, "float32", 1e-6)
    for inp, r in zip(inputs, ref):
        got = _program_logits(arch, params, inp)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, r, rtol=2e-5, atol=2e-5 * float(r.abs().max()))


@pytest.mark.parametrize("config", ["qwen3-32b", "llava-next-34b"])
def test_the_control_reads_far_above_the_program(config):
    """bf16 (the program as configured) against fp8 (the control), both
    against the float32 reference on the same inputs: the control's worst
    logit error is at least three times the program's."""
    arch, model = _arch(config, "bfloat16")
    params = weights.make(model.layout(arch), 11, "cpu")
    inputs = _inputs(arch, 11, [9, 40, 64, 17])
    ref = model.last_logits(arch, params, inputs, "float32", 1e-6)
    got = [_program_logits(arch, params, inp) for inp in inputs]
    prog = check.compared([int(g.argmax()) for g in got], got, ref)
    low = model.last_logits(arch, params, inputs, "fp8", 1e-6)
    ctrl = check.compared([int(x.argmax()) for x in low], low, ref)
    assert prog["label_not_argmax"] == 0
    assert ctrl["logits_rel_err"] > 3 * prog["logits_rel_err"]


@pytest.mark.parametrize("config", ["qwen3-32b", "llava-next-34b"])
def test_weights_are_the_dense_codes_bit_for_bit(config):
    """Every tensor ``weights.make`` draws from the dense module's layout:
    the same type, shape and bytes as before the move (one generator, so
    the same drawing order too)."""
    arch, model = _arch(config, "bfloat16")
    got = {p: [str(t.dtype).split(".")[1], list(t.shape), _sha(t)]
           for p, t in _leaves(weights.make(model.layout(arch), PARITY["seed"], "cpu"))}
    assert got == PARITY["weights"][config]


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_reference_and_control_logits_are_the_dense_codes_bit_for_bit(precision):
    arch, model = _arch("qwen3-32b", "bfloat16")
    assert {k: arch[k] for k in PARITY["small"]} == PARITY["small"]
    seed = PARITY["seed"]
    params = weights.make(model.layout(arch), seed, "cpu")
    inputs = _inputs(arch, seed, PARITY["lengths"])
    got = model.last_logits(arch, params, inputs, precision, 1e-6)
    assert [_sha(x) for x in got] == PARITY["logits"][precision]


def test_weights_layout_is_the_ports():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import model as M
    from repro_torch.models.tree import tree_map_with_path
    for config in ("qwen3-32b", "llava-next-34b"):
        arch, model = _arch(config, "bfloat16")
        want = {}
        tree_map_with_path(lambda p, d: want.__setitem__(p, tuple(d.shape)),
                           M.param_defs(ArchConfig(**dict(
                               arch, block_pattern=tuple(arch["block_pattern"])))),
                           is_leaf=lambda x: hasattr(x, "axes"))
        got = {"".join(f"['{k}']" for k in p.split("/")): tuple(e[0])
               for p, e in model.layout(arch).items()}
        assert got == want
    # qwen3-32b's full layout: the paths, shapes, stds and order the dense
    # decoder's code drew before the move
    bench = spec.load_benchmark()
    confs = {c: spec.config(bench, c) for c in ("qwen3-32b", "llava-next-34b")}
    full = spec.model(confs["qwen3-32b"]).layout(confs["qwen3-32b"]["port"])
    assert [[p, list(e[0]), e[1]] for p, e in full.items()] == PARITY["layout"]
    assert all(len(e) == 2 for e in full.values())
    # the full sizes hold the serving bytes the port reports (PERF.md §5)
    gb = {c: weights.nbytes(spec.model(f).layout(f["port"])) / 1e9
          for c, f in confs.items()}
    assert weights.nbytes(full) == PARITY["nbytes"]
    assert gb["qwen3-32b"] == pytest.approx(65.52, abs=0.01)
    assert gb["llava-next-34b"] == pytest.approx(68.88, abs=0.01)
